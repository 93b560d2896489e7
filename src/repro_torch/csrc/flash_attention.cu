// Flash attention (K2) for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::
// flash_attention (:88, body _flash_kernel :37), which has no backward; the
// two backward kernels here follow the FlashAttention-2 scheme. Per query
// row at position qpos = q_offset + s and key position kpos:
//
//     valid = kpos < T && (!causal || kpos <= qpos)
//             && (!window || qpos - kpos < window)
//     s     = valid ? (q . k) * D^-1/2 : NEG_INF        (NEG_INF = -1e30)
//     o     = softmax(s) v,   lse = m + log(max(l, 1e-30))
//
// with the running max m, sum l and the accumulator kept in float32, the
// same online-softmax arithmetic as the TPU kernel (m starts at -inf, the
// correction is exp(m_prev - m_cur), l is clamped at 1e-30 before the
// division). Query head h reads kv head h / (H / Hkv): GQA without
// repeating k and v.
//
// Layout. Every tensor is addressed through its own (batch, head, position)
// element strides with a unit stride on the head dimension, so the wrapper
// hands over the model's (B, S, H, D) tensors as they are, without
// transposing them. lse is a contiguous (B, H, S) float32 array.
//
// Design: one block of 256 threads per (q-tile of 64 rows, head, batch).
// The TPU kernel's sequential k-block grid axis becomes a loop inside the
// block. Tiles are staged in shared memory as float32 (bf16 inputs are
// widened on load, as the TPU kernel casts them), and every product runs on
// the CUDA cores in float32: the first version is right and simple, not
// fast. Each thread owns a 4 x 4 tile of the 64 x 64 score block and a 4 x
// (D/16) tile of the output. Key tiles wholly above the causal diagonal or
// wholly outside the window are skipped; the wrapper refuses inputs with a
// query row that has no valid key, so every skipped tile contributes an
// exact zero to every row that is written.
//
// Backward (P is recomputed from q, k and lse, never stored):
//   flash_bwd_dkdv: one block per (k-tile, kv head, batch) accumulates dK
//     and dV over every q-tile of every query head of its group, with no
//     atomics, so the result does not depend on scheduling.
//   flash_bwd_dq:   one block per (q-tile, head, batch) accumulates dQ.
// Both recompute D_i = sum_d dO_id O_id for their q rows:
//   P = exp(s - lse), dP = dO V^T, dS = P (dP - D), dV = P^T dO,
//   dK = scale dS^T Q, dQ = scale dS K.
//
// Bound at the zoo path's shape (B 8, H 28, Hkv 4, S = T = 1023, D 128,
// bf16, causal): the forward does 4 B H D S(S+1)/2 = 6.0e10 FLOP and moves
// 135 MB, so it is bound by operations (0.061 ms at the bf16 tensor-core
// peak of 989 TFLOP/s). This version runs those operations in float32 on
// the CUDA cores (67 TFLOP/s peak), so it sits far from that bound. For
// bf16 the forward, dK/dV and dQ run on the tensor cores instead
// (flash_attention_sm90.cu); these kernels serve float32, where TF32
// would change results.
//
// Limits: head_dim 64 or 128; dtype float32 or bfloat16; the dynamic
// shared memory of each kernel (67-167 KB) is opted into with
// cudaFuncSetAttribute at launch. Each launch function returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr float kNegInf = -1e30f;
constexpr int kLDS = kBK + 1;  // row stride of a 64 x 64 score tile

struct Strides {
  long long b, h, s;
};

struct Problem {
  int B, H, Hkv, S, T;
  int causal, has_window, window, q_offset;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Row strides of the float32 tiles in shared memory. A tile read row-wise
// by a warp (the same row in every lane) is padded by 4 so the two rows a
// warp touches fall in different banks; a tile read column-wise (a row per
// lane) is padded by 1.
template <int D>
struct Tiles {
  static constexpr int kLDRow = D + 4;
  static constexpr int kLDCol = D + 1;
};

// rows [r0, r0 + kBQ) of one (batch, head) slice into dst (row stride ld),
// widened to float32; rows >= limit are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ src,
                                          long long row_stride, int r0,
                                          int limit) {
  for (int idx = threadIdx.x; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx - (idx / D) * D;
    const int row = r0 + r;
    dst[r * ld + d] =
        row < limit ? to_f32(src[static_cast<long long>(row) * row_stride + d])
                    : 0.0f;
  }
}

__device__ __forceinline__ bool is_valid(const Problem& p, int qrow,
                                         int kcol) {
  const int qpos = qrow + p.q_offset;
  bool ok = qrow < p.S && kcol < p.T;
  if (p.causal) ok = ok && kcol <= qpos;
  if (p.has_window) ok = ok && (qpos - kcol) < p.window;
  return ok;
}

// The key tiles [begin, end) that hold a valid key for some row of the
// q-tile starting at q0.
__device__ __forceinline__ void key_tiles(const Problem& p, int q0,
                                          int* begin, int* end) {
  const int nk = (p.T + kBK - 1) / kBK;
  const int last_row = min(q0 + kBQ, p.S) - 1;
  const int qpos_lo = q0 + p.q_offset;
  const int qpos_hi = last_row + p.q_offset;
  int e = nk;
  if (p.causal) e = min(nk, qpos_hi / kBK + 1);
  int b = 0;
  if (p.has_window) {
    const int lo = qpos_lo - p.window + 1;  // the oldest key any row sees
    b = lo > 0 ? lo / kBK : 0;
  }
  *begin = b;
  *end = e;
}

// Whether the q-tile at q0 and the key tile at k0 share a valid pair.
__device__ __forceinline__ bool tiles_meet(const Problem& p, int q0,
                                           int k0) {
  const int qpos_lo = q0 + p.q_offset;
  const int qpos_hi = min(q0 + kBQ, p.S) - 1 + p.q_offset;
  const int k_hi = min(k0 + kBK, p.T) - 1;
  if (p.causal && qpos_hi < k0) return false;
  if (p.has_window && qpos_lo - k_hi >= p.window) return false;
  return true;
}

// s[i][j] = sum_d A[ty*4+i][d] * B[tx+16j][d]: A row-padded, B col-padded
template <int D>
__device__ __forceinline__ void tile_qkT(float (&s)[4][4],
                                         const float* __restrict__ A,
                                         const float* __restrict__ Bm,
                                         int ty, int tx) {
  constexpr int LA = Tiles<D>::kLDRow, LB = Tiles<D>::kLDCol;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * LA + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bm[(tx + 16 * j) * LB + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// ---------------------------------------------------------------- forward

template <int D>
constexpr int fwd_smem_floats() {
  return kBQ * Tiles<D>::kLDRow + kBK * Tiles<D>::kLDCol + kBK * D +
         kBQ * kLDS + 3 * kBQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, Strides sq, Strides sk,
                     Strides sv, Strides so, Problem p) {
  extern __shared__ float smem[];
  constexpr int LQ = Tiles<D>::kLDRow, LK = Tiles<D>::kLDCol;
  constexpr int NC = D / 16;
  float* Qs = smem;
  float* Ks = Qs + kBQ * LQ;
  float* Vs = Ks + kBK * LK;
  float* Ss = Vs + kBK * D;
  float* row_m = Ss + kBQ * kLDS;
  float* row_l = row_m + kBQ;
  float* row_c = row_l + kBQ;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  load_tile<T, D>(Qs, LQ, qb, sq.s, q0, p.S);
  if (tid < kBQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.0f;
  }
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.0f;

  int kt0, kt1;
  key_tiles(p, q0, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, LK, kb, sk.s, k0, p.T);
    load_tile<T, D>(Vs, D, vb, sv.s, k0, p.T);
    __syncthreads();
    float s[4][4];
    tile_qkT<D>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, c = tx + 16 * j;
        Ss[r * kLDS + c] =
            is_valid(p, q0 + r, k0 + c) ? s[i][j] * p.scale : kNegInf;
      }
    __syncthreads();
    {  // online softmax: four neighbouring lanes per row, 16 keys each
      const int r = tid / 4, part = tid % 4;
      float* srow = Ss + r * kLDS + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = row_m[r];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float e = expf(srow[c] - m_cur);
        srow[c] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_cur);
        row_c[r] = corr;
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = m_cur;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = row_c[ty * 4 + i];
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= c;
    }
#pragma unroll 2
    for (int t = 0; t < kBK; ++t) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty * 4 + i) * kLDS + t];
#pragma unroll
      for (int n = 0; n < NC; ++n) vv[n] = Vs[t * D + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(pv[i], vv[n], acc[i][n]);
    }
  }
  __syncthreads();
  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, row = q0 + r;
    if (row >= p.S) continue;
    const float l = fmaxf(row_l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < NC; ++n)
      ob[static_cast<long long>(row) * so.s + tx + 16 * n] =
          from_f32<T>(acc[i][n] / l);
    if (tx == 0)
      lse[(static_cast<long long>(b) * p.H + h) * p.S + row] =
          row_m[r] + logf(l);
  }
}

// --------------------------------------------------------------- backward

// Stage one q-tile of query head h: Q and dO (float32), lse and
// D_i = sum_d dO_id O_id for its rows (zero for rows past S).
template <typename T, int D>
__device__ __forceinline__ void load_q_side(
    float* Qs, float* dOs, float* lse_s, float* Ds, const T* __restrict__ q,
    const T* __restrict__ o, const T* __restrict__ dout,
    const float* __restrict__ lse, Strides sq, Strides so, Strides sd,
    const Problem& p, int b, int h, int q0) {
  constexpr int LQ = Tiles<D>::kLDRow;
  load_tile<T, D>(Qs, LQ, q + b * sq.b + h * sq.h, sq.s, q0, p.S);
  load_tile<T, D>(dOs, LQ, dout + b * sd.b + h * sd.h, sd.s, q0, p.S);
  __syncthreads();
  const int r = threadIdx.x / 4, part = threadIdx.x % 4;
  const int row = q0 + r;
  float dsum = 0.0f;
  if (row < p.S) {
    const T* orow = o + b * so.b + h * so.h + static_cast<long long>(row) * so.s;
    for (int d = part; d < D; d += 4) dsum = fmaf(dOs[r * LQ + d], to_f32(orow[d]), dsum);
  }
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
  if (part == 0) {
    Ds[r] = dsum;
    lse_s[r] = row < p.S
                   ? lse[(static_cast<long long>(b) * p.H + h) * p.S + row]
                   : 0.0f;
  }
}

// P and dS of one (q-tile, key tile) pair into Ps / dSs ([q][k], stride
// kLDS). Q, dO row-padded; K, V col-padded.
template <int D>
__device__ __forceinline__ void tile_p_ds(float* Ps, float* dSs,
                                          const float* Qs, const float* dOs,
                                          const float* Ks, const float* Vs,
                                          const float* lse_s, const float* Ds,
                                          const Problem& p, int q0, int k0,
                                          int ty, int tx) {
  float s[4][4], dp[4][4];
  tile_qkT<D>(s, Qs, Ks, ty, tx);
  tile_qkT<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty * 4 + i, c = tx + 16 * j;
      const float pr = is_valid(p, q0 + r, k0 + c)
                           ? expf(s[i][j] * p.scale - lse_s[r])
                           : 0.0f;
      if (Ps != nullptr) Ps[r * kLDS + c] = pr;
      dSs[r * kLDS + c] = pr * (dp[i][j] - Ds[r]);
    }
}

template <int D>
constexpr int dkdv_smem_floats() {
  return 2 * kBQ * Tiles<D>::kLDRow + 2 * kBK * Tiles<D>::kLDCol +
         2 * kBQ * kLDS + 2 * kBQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ o,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse, T* __restrict__ dk,
                          T* __restrict__ dv, Strides sq, Strides sk,
                          Strides sv, Strides so, Strides sd, Strides sdk,
                          Strides sdv, Problem p) {
  extern __shared__ float smem[];
  constexpr int LQ = Tiles<D>::kLDRow, LK = Tiles<D>::kLDCol;
  constexpr int NC = D / 16;
  float* Qs = smem;
  float* dOs = Qs + kBQ * LQ;
  float* Ks = dOs + kBQ * LQ;
  float* Vs = Ks + kBK * LK;
  float* Ps = Vs + kBK * LK;
  float* dSs = Ps + kBQ * kLDS;
  float* lse_s = dSs + kBQ * kLDS;
  float* Ds = lse_s + kBQ;

  const int k0 = blockIdx.x * kBK, hk = blockIdx.y, b = blockIdx.z;
  const int g = p.H / p.Hkv;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  load_tile<T, D>(Ks, LK, k + b * sk.b + hk * sk.h, sk.s, k0, p.T);
  load_tile<T, D>(Vs, LK, v + b * sv.b + hk * sv.h, sv.s, k0, p.T);

  float acc_k[4][NC], acc_v[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc_k[i][n] = acc_v[i][n] = 0.0f;

  const int nq = (p.S + kBQ - 1) / kBQ;
  for (int gi = 0; gi < g; ++gi) {
    const int h = hk * g + gi;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * kBQ;
      if (!tiles_meet(p, q0, k0)) continue;
      __syncthreads();  // the previous tile's readers are done
      load_q_side<T, D>(Qs, dOs, lse_s, Ds, q, o, dout, lse, sq, so, sd, p,
                        b, h, q0);
      __syncthreads();
      tile_p_ds<D>(Ps, dSs, Qs, dOs, Ks, Vs, lse_s, Ds, p, q0, k0, ty, tx);
      __syncthreads();
      // dV[kk] += sum_q P[q][kk] dO[q];  dK[kk] += sum_q dS[q][kk] Q[q]
#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        float pq[4], dsq[4], dov[NC], qv[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pq[i] = Ps[r * kLDS + ty * 4 + i];
          dsq[i] = dSs[r * kLDS + ty * 4 + i];
        }
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          dov[n] = dOs[r * LQ + tx + 16 * n];
          qv[n] = Qs[r * LQ + tx + 16 * n];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            acc_v[i][n] = fmaf(pq[i], dov[n], acc_v[i][n]);
            acc_k[i][n] = fmaf(dsq[i], qv[n], acc_k[i][n]);
          }
      }
    }
  }
  T* dkb = dk + b * sdk.b + hk * sdk.h;
  T* dvb = dv + b * sdv.b + hk * sdv.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = k0 + ty * 4 + i;
    if (kk >= p.T) continue;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int c = tx + 16 * n;
      dkb[static_cast<long long>(kk) * sdk.s + c] =
          from_f32<T>(acc_k[i][n] * p.scale);
      dvb[static_cast<long long>(kk) * sdv.s + c] = from_f32<T>(acc_v[i][n]);
    }
  }
}

template <int D>
constexpr int dq_smem_floats() {
  return 2 * kBQ * Tiles<D>::kLDRow + 2 * kBK * Tiles<D>::kLDCol +
         kBQ * kLDS + 2 * kBQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse, T* __restrict__ dq,
                        Strides sq, Strides sk, Strides sv, Strides so,
                        Strides sd, Strides sdq, Problem p) {
  extern __shared__ float smem[];
  constexpr int LQ = Tiles<D>::kLDRow, LK = Tiles<D>::kLDCol;
  constexpr int NC = D / 16;
  float* Qs = smem;
  float* dOs = Qs + kBQ * LQ;
  float* Ks = dOs + kBQ * LQ;
  float* Vs = Ks + kBK * LK;
  float* dSs = Vs + kBK * LK;
  float* lse_s = dSs + kBQ * kLDS;
  float* Ds = lse_s + kBQ;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  load_q_side<T, D>(Qs, dOs, lse_s, Ds, q, o, dout, lse, sq, so, sd, p, b,
                    h, q0);

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.0f;

  int kt0, kt1;
  key_tiles(p, q0, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile<T, D>(Ks, LK, kb, sk.s, k0, p.T);
    load_tile<T, D>(Vs, LK, vb, sv.s, k0, p.T);
    __syncthreads();
    tile_p_ds<D>(nullptr, dSs, Qs, dOs, Ks, Vs, lse_s, Ds, p, q0, k0, ty,
                 tx);
    __syncthreads();
    // dQ[q] += sum_kk dS[q][kk] K[kk]
#pragma unroll 2
    for (int t = 0; t < kBK; ++t) {
      float ds[4], kv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty * 4 + i) * kLDS + t];
#pragma unroll
      for (int n = 0; n < NC; ++n) kv[n] = Ks[t * LK + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(ds[i], kv[n], acc[i][n]);
    }
  }
  T* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.S) continue;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      dqb[static_cast<long long>(row) * sdq.s + tx + 16 * n] =
          from_f32<T>(acc[i][n] * p.scale);
  }
}

// ----------------------------------------------------------------- launch

Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        const long long* st, Problem p, cudaStream_t stream) {
  const size_t bytes = fwd_smem_floats<D>() * sizeof(float);
  cudaError_t err = opt_in(flash_fwd_kernel<T, D>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.S + kBQ - 1) / kBQ, p.H, p.B);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd_dkdv(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, void* dk, void* dv,
             const long long* st, Problem p, cudaStream_t stream) {
  const size_t bytes = dkdv_smem_floats<D>() * sizeof(float);
  cudaError_t err = opt_in(flash_bwd_dkdv_kernel<T, D>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.T + kBK - 1) / kBK, p.Hkv, p.B);
  flash_bwd_dkdv_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, static_cast<T*>(dk),
      static_cast<T*>(dv), strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4),
      strides_at(st, 5), strides_at(st, 6), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* dq,
           const long long* st, Problem p, cudaStream_t stream) {
  const size_t bytes = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = opt_in(flash_bwd_dq_kernel<T, D>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.S + kBQ - 1) / kBQ, p.H, p.B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, static_cast<T*>(dq),
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), strides_at(st, 4), strides_at(st, 5), p);
  return static_cast<int>(cudaGetLastError());
}

Problem make_problem(int B, int H, int Hkv, int S, int T, int causal,
                     int has_window, int window, int q_offset, float scale) {
  return Problem{B, H, Hkv, S, T, causal, has_window, window, q_offset,
                 scale};
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. head_dim: 64 or 128. strides: three
// (batch, head, position) element strides per tensor, in argument order.
// Returns cudaErrorInvalidValue for a dtype or head_dim it does not take;
// the caller checks shapes, devices and the unit stride of the last axis.
#define K2_DISPATCH(CALL)                                                 \
  if (dtype == 0 && head_dim == 64) return CALL(float, 64);               \
  if (dtype == 0 && head_dim == 128) return CALL(float, 128);             \
  if (dtype == 1 && head_dim == 64) return CALL(__nv_bfloat16, 64);       \
  if (dtype == 1 && head_dim == 128) return CALL(__nv_bfloat16, 128);     \
  return static_cast<int>(cudaErrorInvalidValue);

extern "C" int flash_attention_fwd(int dtype, int head_dim, const void* q,
                                   const void* k, const void* v, void* o,
                                   float* lse, const long long* strides,
                                   int B, int H, int Hkv, int S, int T,
                                   int causal, int has_window, int window,
                                   int q_offset, float scale, void* stream) {
  const Problem p = make_problem(B, H, Hkv, S, T, causal, has_window, window,
                                 q_offset, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K2_FWD(TY, DIM) fwd<TY, DIM>(q, k, v, o, lse, strides, p, st)
  K2_DISPATCH(K2_FWD)
#undef K2_FWD
}

extern "C" int flash_attention_bwd_dkdv(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const void* o, const void* dout, const float* lse, void* dk, void* dv,
    const long long* strides, int B, int H, int Hkv, int S, int T,
    int causal, int has_window, int window, int q_offset, float scale,
    void* stream) {
  const Problem p = make_problem(B, H, Hkv, S, T, causal, has_window, window,
                                 q_offset, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K2_DKDV(TY, DIM) \
  bwd_dkdv<TY, DIM>(q, k, v, o, dout, lse, dk, dv, strides, p, st)
  K2_DISPATCH(K2_DKDV)
#undef K2_DKDV
}

extern "C" int flash_attention_bwd_dq(
    int dtype, int head_dim, const void* q, const void* k, const void* v,
    const void* o, const void* dout, const float* lse, void* dq,
    const long long* strides, int B, int H, int Hkv, int S, int T,
    int causal, int has_window, int window, int q_offset, float scale,
    void* stream) {
  const Problem p = make_problem(B, H, Hkv, S, T, causal, has_window, window,
                                 q_offset, scale);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K2_DQ(TY, DIM) \
  bwd_dq<TY, DIM>(q, k, v, o, dout, lse, dq, strides, p, st)
  K2_DISPATCH(K2_DQ)
#undef K2_DQ
}
