// Mamba2 SSD chunk kernel (K3) for Hopper (sm_90a): the intra-chunk terms
// of the chunked state-space-duality scan.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py::
// ssd_chunk_pallas (:72, pallas_call :98, body _ssd_chunk_kernel :36).
// Per (batch b, head h, chunk c) of Q positions, with x (Q, P), dt (Q,),
// the head's a, and B, C (Q, N) of the head's group h / (H / G):
//
//     cs_i      = sum_{k <= i} dt_k a                (within the chunk)
//     y_i       = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//     state     = sum_j (B_j exp(cs_{Q-1} - cs_j) dt_j)^T x_j     (N, P)
//     decay     = exp(cs_{Q-1})
//
// y is written in x's dtype; state, cs and decay in float32, as the TPU
// kernel writes them. The weight of a pair is formed as the TPU kernel
// forms it, (C_i . B_j) exp(cs_i - cs_j) and then dt_j, and the state's
// row weight as exp(cs_last - cs_j) dt_j; exp is never evaluated above the
// diagonal (cs_i - cs_j > 0 there and can overflow).
//
// Layout. x (B, S, H, P), dt (B, S, H) and B, C (B, S, G, N) are read in
// place through their (batch, position, head-or-group) element strides,
// with a unit stride on the last axis, so the model's tensors need no
// transpose. Outputs are contiguous: y (B, S, H, P), states (B, nc, H, N,
// P), cs (B, nc, H, Q), decay (B, nc, H). Offsets are 64-bit (B S H P
// passes 2^31 at long prompts).
//
// Design: one launch, blocks of 256 threads (a 16 x 16 grid) on (nc (T +
// 1), H, B), where T = ceil(Q / 64). Blocks run in parallel and in no
// order, so each recomputes the cumsum of its own chunk (one warp, eight
// terms a lane, then a shuffle scan). Of the T + 1 blocks of a chunk, the
// first T each own 64 query rows i: they loop over the key tiles j <= i
// (the tiles above the diagonal are skipped; the TPU kernel holds the
// whole (Q, Q) block in VMEM, 256 KB at Q = 256, more than a Hopper block
// has), form the 64 x 64 scores C B^T, weight them into shared memory and
// accumulate the weighted x. The last block reduces the chunk's Q rows
// into the (N, P) state. Tiles are staged in shared memory as float32
// (bf16 inputs widened on load) and every product is an fmaf on the CUDA
// cores: the first version is right and simple, not fast.
//
// Bound at the serving path's shape (B 8, S 2048, H 64, P 64, G 1, N 128,
// Q 256, float32): the causal half of the products is 6.9e10 FLOP and the
// bytes 696 MB, so it is bound by operations: 1.03 ms at the float32
// CUDA-core peak of 67 TFLOP/s, against 0.21 ms for the bytes. Tensor cores
// (TF32 would change the results; bf16 wgmma for bf16 inputs) are later
// work.
//
// Limits: Q <= 256, N <= 128, P <= 128, G divides H; dtype float32 or
// bfloat16 for x, B and C (the same for all three); dt and a float32. The
// dynamic shared memory (up to 118 KB) is opted into with
// cudaFuncSetAttribute at launch. The launch function returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;          // rows per tile
constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kMaxQ = 256;
constexpr int kMaxN = 128;
constexpr int kLDW = kT + 1;    // row stride of the 64 x 64 weight tile

struct Strides {
  long long b, s, h;
};

struct Dims {
  int B, S, H, G, P, N, Q, nc;
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

// rows [r0, r0 + kT) of the chunk (row r at position t0 + r) and columns
// [0, width) of one (batch, head/group) slice into dst (row stride ld),
// widened to float32; rows >= Q and columns >= cols are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, int width,
                                          const T* __restrict__ src,
                                          long long row_stride, int r0,
                                          int Q, int cols) {
  for (int idx = threadIdx.x; idx < kT * width; idx += kThreads) {
    const int r = idx / width, k = idx - (idx / width) * width;
    const int row = r0 + r;
    dst[r * ld + k] =
        (row < Q && k < cols)
            ? to_f32(src[static_cast<long long>(row) * row_stride + k])
            : 0.0f;
  }
}

// cs[i] = sum_{k <= i} dt[i] a for i < Q: warp 0, eight terms a lane
// (Q <= 256), a shuffle scan over the lanes' sums.
__device__ __forceinline__ void chunk_cumsum(float* cs, const float* dts,
                                             float a, int Q) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int per = (Q + 31) / 32;
  const int lo = min(lane * per, Q), hi = min(lo + per, Q);
  float run = 0.0f;
  for (int i = lo; i < hi; ++i) run += dts[i] * a;
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  float acc = incl - run;  // the sum of the lanes before this one
  for (int i = lo; i < hi; ++i) {
    acc += dts[i] * a;
    cs[i] = acc;
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a_h, const T* __restrict__ bm,
                     const T* __restrict__ cm, T* __restrict__ y,
                     float* __restrict__ states, float* __restrict__ cs_out,
                     float* __restrict__ decay_out, Strides sx, Strides sdt,
                     Strides sb, Strides sc, Dims d) {
  extern __shared__ float smem[];
  constexpr int XW = NC * 16;      // x tile width: P padded to 16s
  float* cs = smem;
  float* dts = cs + kMaxQ;
  float* work = dts + kMaxQ;

  const int n_qt = (d.Q + kT - 1) / kT;
  const int role = blockIdx.x % (n_qt + 1);
  const int c = blockIdx.x / (n_qt + 1);
  const int h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (d.H / d.G);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long t0 = static_cast<long long>(c) * d.Q;

  const T* xb = x + b * sx.b + t0 * sx.s + h * sx.h;
  const T* bb = bm + b * sb.b + t0 * sb.s + grp * sb.h;
  const T* cb = cm + b * sc.b + t0 * sc.s + grp * sc.h;
  const float* dtb = dt + b * sdt.b + t0 * sdt.s + h * sdt.h;
  for (int i = tid; i < d.Q; i += kThreads) dts[i] = dtb[i * sdt.s];
  __syncthreads();
  chunk_cumsum(cs, dts, a_h[h], d.Q);
  __syncthreads();

  if (role < n_qt) {
    // ---- y for query rows [i0, i0 + 64)
    const int i0 = role * kT;
    const int LC = d.N + 4, LB = d.N + 1;
    float* Cs = work;              // [row][n], read row-wise
    float* Bs = Cs + kT * LC;      // [row][n], read column-wise
    float* Xs = Bs + kT * LB;      // [row][p], XW wide
    float* Ws = Xs + kT * XW;      // [i][j]
    load_tile<T>(Cs, LC, d.N, cb, sc.s, i0, d.Q, d.N);
    float acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] = 0.0f;

    for (int jt = 0; jt <= role; ++jt) {
      const int j0 = jt * kT;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T>(Bs, LB, d.N, bb, sb.s, j0, d.Q, d.N);
      load_tile<T>(Xs, XW, XW, xb, sx.s, j0, d.Q, d.P);
      __syncthreads();
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < d.N; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * LC + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * LB + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty * 4 + i, col = tx + 16 * j;
          const int gi = i0 + r, gj = j0 + col;
          float w = 0.0f;
          if (gj <= gi && gi < d.Q)
            w = (s[i][j] * expf(cs[gi] - cs[gj])) * dts[gj];
          Ws[r * kLDW + col] = w;
        }
      __syncthreads();
#pragma unroll 2
      for (int t = 0; t < kT; ++t) {
        float wv[4], xv[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[i] = Ws[(ty * 4 + i) * kLDW + t];
#pragma unroll
        for (int n = 0; n < NC; ++n) xv[n] = Xs[t * XW + tx + 16 * n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(wv[i], xv[n], acc[i][n]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i0 + ty * 4 + i;
      if (row >= d.Q) continue;
      T* yr = y + ((static_cast<long long>(b) * d.S + t0 + row) * d.H + h) *
                      d.P;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int col = tx + 16 * n;
        if (col < d.P) yr[col] = from_f32<T>(acc[i][n]);
      }
    }
    return;
  }

  // ---- the chunk's state (N, P), its cs and its decay
  const float last = cs[d.Q - 1];
  constexpr int NR = kMaxN / 16;
  float* Bw = work;                // [row][n], kMaxN wide, weighted
  float* Xs = Bw + kT * kMaxN;     // [row][p], XW wide
  float acc[NR][NC];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.0f;
  for (int j0 = 0; j0 < d.Q; j0 += kT) {
    __syncthreads();
    for (int idx = tid; idx < kT * kMaxN; idx += kThreads) {
      const int r = idx / kMaxN, k = idx % kMaxN;
      const int row = j0 + r;
      float v = 0.0f;
      if (row < d.Q && k < d.N)
        v = to_f32(bb[static_cast<long long>(row) * sb.s + k]) *
            (expf(last - cs[row]) * dts[row]);
      Bw[idx] = v;
    }
    load_tile<T>(Xs, XW, XW, xb, sx.s, j0, d.Q, d.P);
    __syncthreads();
    const int rows = min(kT, d.Q - j0);
    for (int t = 0; t < rows; ++t) {
      float bv[NR], xv[NC];
#pragma unroll
      for (int i = 0; i < NR; ++i) bv[i] = Bw[t * kMaxN + ty + 16 * i];
#pragma unroll
      for (int n = 0; n < NC; ++n) xv[n] = Xs[t * XW + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(bv[i], xv[n], acc[i][n]);
    }
  }
  const long long cell = (static_cast<long long>(b) * d.nc + c) * d.H + h;
  float* st = states + cell * d.N * d.P;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int n = ty + 16 * i;
    if (n >= d.N) continue;
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int p = tx + 16 * k;
      if (p < d.P) st[static_cast<long long>(n) * d.P + p] = acc[i][k];
    }
  }
  for (int i = tid; i < d.Q; i += kThreads) cs_out[cell * d.Q + i] = cs[i];
  if (tid == 0) decay_out[cell] = expf(last);
}

template <int NC>
size_t smem_bytes(int N) {
  const int query = kT * (N + 4) + kT * (N + 1) + kT * NC * 16 + kT * kLDW;
  const int state = kT * kMaxN + kT * NC * 16;
  return (2 * kMaxQ + (query > state ? query : state)) * sizeof(float);
}

template <typename T, int NC>
int launch(const void* x, const float* dt, const float* a_h, const void* bm,
           const void* cm, void* y, float* states, float* cs, float* decay,
           const long long* st, Dims d, cudaStream_t stream) {
  const size_t bytes = smem_bytes<NC>(d.N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (d.Q + kT - 1) / kT;
  dim3 grid(d.nc * (n_qt + 1), d.H, d.B);
  const Strides sx{st[0], st[1], st[2]}, sdt{st[3], st[4], st[5]},
      sb{st[6], st[7], st[8]}, sc{st[9], st[10], st[11]};
  ssd_chunk_kernel<T, NC><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, a_h, static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(y), states, cs, decay, sx,
      sdt, sb, sc, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, bm, cm and y). strides: three
// (batch, position, head-or-group) element strides each for x, dt, bm, cm.
// Returns cudaErrorInvalidValue for a dtype or size it does not take; the
// caller checks shapes, devices and the unit stride of the last axis.
extern "C" int ssd_chunk_fwd(int dtype, const void* x, const float* dt,
                             const float* a_h, const void* bm, const void* cm,
                             void* y, float* states, float* cs, float* decay,
                             const long long* strides, int B, int S, int H,
                             int G, int P, int N, int Q, void* stream) {
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || P < 1 || P > 128 ||
      G < 1 || H % G != 0 || S % Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{B, S, H, G, P, N, Q, S / Q};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K3_LAUNCH(TY, NCOLS)                                               \
  launch<TY, NCOLS>(x, dt, a_h, bm, cm, y, states, cs, decay, strides, d, s)
  if (dtype == 0) {
    if (P <= 32) return K3_LAUNCH(float, 2);
    if (P <= 64) return K3_LAUNCH(float, 4);
    return K3_LAUNCH(float, 8);
  }
  if (dtype == 1) {
    if (P <= 32) return K3_LAUNCH(__nv_bfloat16, 2);
    if (P <= 64) return K3_LAUNCH(__nv_bfloat16, 4);
    return K3_LAUNCH(__nv_bfloat16, 8);
  }
#undef K3_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
