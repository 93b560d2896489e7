// Mamba2 SSD chunk kernel (K3) on Hopper's tensor cores (sm_90a): the
// intra-chunk terms of the chunked state-space-duality scan, every product
// float32-accurate through 3xTF32 mma.sync.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py::
// ssd_chunk_pallas (:72, pallas_call :98, body _ssd_chunk_kernel :36), in
// the same layouts and types: per (batch b, head h, chunk c) of Q
// positions, with x (Q, P), dt (Q,), the head's a, and B, C (Q, N) of the
// head's group h / (H / G),
//
//     cs_i      = sum_{k <= i} dt_k a                (within the chunk)
//     y_i       = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//     state     = sum_j (B_j exp(cs_{Q-1} - cs_j) dt_j)^T x_j     (N, P)
//     decay     = exp(cs_{Q-1})
//
// x (B, S, H, P), dt (B, S, H) and B, C (B, S, G, N) are read in place
// through their (batch, position, head-or-group) element strides, with a
// unit stride on the last axis. Outputs are contiguous: y (B, S, H, P) in
// x's dtype; states (B, nc, H, N, P), cs (B, nc, H, Q) and decay (B, nc, H)
// in float32. Offsets are 64-bit.
//
// Scores once per head slab. C_i . B_j depends on the group, not the head,
// and Mamba2-1.3B has one group of 64 heads. A y-block owns (batch, chunk,
// 64 query rows i, a slab of up to `slab` heads of one group; a slab never
// straddles two groups): it forms the 64 x 64(i+1) score panel S = C_i B^T
// of its key tiles j <= i once, into shared memory, then loops over its
// heads. For each head it forms W = S * exp(cs_i - cs_j) * dt_j in
// registers, straight in the mma A fragment's layout (exp is never
// evaluated above the diagonal, where cs_i - cs_j > 0 can overflow; the
// weight is formed as the TPU kernel forms it, (S exp) and then dt), and
// accumulates y += W x_j. A state block owns (batch, chunk, 64 rows of N,
// the same slab): it keeps those 64 columns of B for the whole chunk in
// shared memory and per head accumulates state += (B * w)^T x_j, w_j =
// exp(cs_last - cs_j) dt_j. Every output element has one writer: no
// atomics, the outputs are deterministic. Blocks run the heaviest first:
// the last query tile (scores and T key tiles), the state blocks (T key
// tiles), then the other query tiles.
//
// 3xTF32. Each float32 operand is split a = hi + lo, hi = tf32(a), lo =
// tf32(a - hi), rounded explicitly as cvt.rna.tf32.f32 rounds (to nearest,
// ties away; the low 13 bits cleared, so hi is exactly the value the
// tensor core reads; a raw float32 handed to it would be truncated
// instead), and a b is summed as lo_a hi_b + hi_a lo_b + hi_a hi_b, the
// small terms first, into float32 accumulators. The dropped lo_a lo_b and the rounding of lo are each
// below 2^-22 |a b|: about 2^-21 relative per product, float32's own
// order, where one TF32 pass keeps 2^-11. bf16 inputs are exact in TF32
// (8 mantissa bits against 10), so x, B and C then take no lo part and
// only W and B * w (float32 products) are split: two products, not three.
//
// Staging. Tiles of x and of the score product's C and B stream through
// two buffers by cp.async (16 bytes a thread, zero-filled past the chunk's
// last row and the last column), so the next tile's load overlaps this
// tile's products; the next head's dt comes with its first x tile (4-byte
// copies). An input whose address, strides or row are not multiples of 16
// bytes takes the synchronous route (ASYNC = false, chosen by the wrapper
// from the tensors' shapes): plain loads into the same buffers, the same
// arithmetic, so both routes give the same bits. The score product stages
// 32 columns of N at a time in the buffers that later hold x.
//
// Bound at the serving path's shape (B 8, S 2048, H 64, P 64, G 1, N 128,
// Q 256, float32): the least work is the scores once per (batch, chunk,
// group), 2 Q(Q+1)/2 N = 8.4e6 FLOP x 64 = 5.4e8, y 2 Q(Q+1)/2 P x 4096
// (batch, chunk, head) = 1.72e10 and the states 2 Q N P x 4096 = 1.72e10:
// 3.50e10 FLOP, three TF32 products each, 3 x 3.50e10 / 495e12 = 0.21 ms;
// the bytes (x, dt, B, C read once; y, states, cs, decay written once) are
// 696 MB, 0.21 ms at 3.35 TB/s. With slabs of 16 heads the kernel forms
// the scores 4 times per group (2.7e9 FLOP) and the diagonal tiles' y in
// 8-column steps (1.83e10), 3.82e10 FLOP in all.
//
// Resources (ptxas -v, sm_90a): float32 141 registers at P <= 64 (138 on
// the synchronous route), 160 and 158 at P 128; bf16 136 / 138 and
// 161 / 154; no spills. Shared memory per block
// at Q 256, float32, P <= 64: 4 KB of per-position scalars, the 64 x 260
// float score panel or the 256 x 72 B panel (72 KB), and two 18 KB staging
// buffers: 112 KB, two blocks of 128 threads an SM; P 128 widens the
// buffers (144 KB, one block an SM). The SASS holds 480 HMMA at float32
// and P <= 64 (864 at P 128; bf16 288 and 544).
//
// Limits: Q <= 256, N <= 128, P <= 128, G divides H; x, B and C float32 or
// bfloat16 (the same for all three); dt and a float32. The launch function
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;          // rows of every tile
constexpr int kThreads = 128;   // four warps, 16 rows of a tile each
constexpr int kMaxQ = 256;
constexpr int kMaxN = 128;
constexpr int kKC = 32;         // columns of N per stage of the scores
constexpr int kLDB = kT + 8;    // row stride of the state block's B panel
constexpr size_t kScalarBytes = 4 * kMaxQ * sizeof(float);

struct Strides {
  long long b, s, h;
};

struct Dims {
  int B, S, H, G, P, N, Q, nc;
  int T;                // 64-row tiles in a chunk
  int rep;              // heads per group
  int slab;             // heads per block, at most rep
  int slabs_per_group;
  int n_state;          // state blocks per slab: 64-row blocks of N
};

// Row strides (elements) of the staging tiles. A fragment reads element
// (row g, column t) or (row t, column g) of an 8 x 4 quad pattern; a row
// stride of 4 (mod 32) words serves the first and 8 (mod 32) the second
// without bank conflicts, and every row starts on 16 bytes for cp.async.
template <typename T>
__host__ __device__ constexpr int ld_k() {
  return sizeof(T) == 4 ? kKC + 4 : kKC + 8;
}
template <int PW>
__host__ __device__ constexpr int ld_x() {
  return PW + 8;
}

template <typename T, int PW>
__host__ __device__ constexpr size_t stage_half_bytes() {
  return (2 * kT * ld_k<T>() > kT * ld_x<PW>() ? 2 * kT * ld_k<T>()
                                                 : kT * ld_x<PW>()) *
         sizeof(T);
}

// the score panel (y-blocks) or the B panel (state blocks)
template <typename T>
__host__ __device__ inline size_t panel_bytes(int tiles) {
  const size_t s = size_t(kT) * (kT * tiles + 4) * sizeof(float);
  const size_t bp = size_t(kT) * tiles * kLDB * sizeof(T);
  return s > bp ? s : bp;
}

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src, or zeros when bytes is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + rows) of a chunk's slice (row r at src + r * row_stride)
// and its columns [c0, c0 + width) into dst (row stride ld); rows >= Q and
// columns >= cols are zero. ASYNC: 16-byte copies, which need src, the
// row stride, c0 and cols in whole 16 bytes (the wrapper's route).
template <typename T, bool ASYNC>
__device__ __forceinline__ void stage(T* dst, int ld, int rows, int width,
                                      const T* __restrict__ src,
                                      long long row_stride, int r0, int Q,
                                      int c0, int cols) {
  if constexpr (ASYNC) {
    constexpr int V = 16 / sizeof(T);
    const int per_row = width / V;
    for (int idx = threadIdx.x; idx < rows * per_row; idx += kThreads) {
      const int r = idx / per_row, k = (idx - r * per_row) * V;
      const int row = r0 + r, col = c0 + k;
      const bool ok = row < Q && col < cols;
      cp_async16(dst + r * ld + k, ok ? src + row * row_stride + col : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * width; idx += kThreads) {
      const int r = idx / width, k = idx - r * width;
      const int row = r0 + r, col = c0 + k;
      dst[r * ld + k] = (row < Q && col < cols)
                            ? src[row * row_stride + col]
                            : from_f32<T>(0.0f);
    }
  }
}

// the value's TF32 bits: round to nearest, ties away, low 13 bits cleared.
// Adding half of the dropped ulp to the magnitude's bits and clearing them
// is cvt.rna.tf32.f32's rounding bit for bit (a carry into the exponent is
// the rounding up; infinities stay), in two integer instructions where
// ptxas expands cvt.rna into a longer sequence on sm_90a.
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo to within 2^-22 |v| (EXACT: v is a bf16 value, lo = 0)
template <bool EXACT>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  if constexpr (EXACT) {
    hi = __float_as_uint(v);
    lo = 0u;
  } else {
    hi = tf32(v);
    lo = tf32(v - __uint_as_float(hi));
  }
}

// c += a b on the tensor cores, m16n8k8, TF32 operands, float32 sums
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[n] += a b[n] for every n-tile to float32 accuracy: the lo hi and hi
// lo terms of all n-tiles first (independent products back to back), then
// hi hi; a term whose lo part is zero by construction is skipped
template <int NT, bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3(float (&acc)[NT][4],
                                     const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const uint32_t (&bhi)[NT][2],
                                     const uint32_t (&blo)[NT][2]) {
  if constexpr (!A_EXACT) {
#pragma unroll
    for (int n = 0; n < NT; ++n) mma(acc[n], alo, bhi[n]);
  }
  if constexpr (!B_EXACT) {
#pragma unroll
    for (int n = 0; n < NT; ++n) mma(acc[n], ahi, blo[n]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) mma(acc[n], ahi, bhi[n]);
}

// The B fragments of one k-step of x, split: xf points at this thread's
// (row t, column g) of the staged tile, so rows k0 + t and k0 + t + 4 and
// columns n 8 + g are constant offsets.
template <typename T, int NT, int LDX>
__device__ __forceinline__ void x_frags(const T* xf, int k0,
                                        uint32_t (&hi)[NT][2],
                                        uint32_t (&lo)[NT][2]) {
  constexpr bool kExact = sizeof(T) == 2;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    split<kExact>(to_f32(xf[k0 * LDX + n * 8]), hi[n][0], lo[n][0]);
    split<kExact>(to_f32(xf[(k0 + 4) * LDX + n * 8]), hi[n][1], lo[n][1]);
  }
}

// cs[i] = sum_{k <= i} dt[k] a for i < Q (Q <= 256), by one warp: eight
// terms a lane, then a shuffle scan over the lanes' sums.
__device__ __forceinline__ void chunk_cumsum(float* cs, const float* dts,
                                             float a, int Q, int lane) {
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

template <typename T, int PW, bool ASYNC>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_chunk_tc_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ a_h,
                        const T* __restrict__ bm, const T* __restrict__ cm,
                        T* __restrict__ y, float* __restrict__ states,
                        float* __restrict__ cs_out,
                        float* __restrict__ decay_out, Strides sx,
                        Strides sdt, Strides sb, Strides sc, Dims d) {
  constexpr bool kExact = sizeof(T) == 2;
  constexpr int LDK = ld_k<T>(), LDX = ld_x<PW>(), NT = PW / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* dts = reinterpret_cast<float*>(smem);  // [2][kMaxQ]: dt by head
  float* cs = dts + 2 * kMaxQ;                  // this head's cumsum
  float* wst = cs + kMaxQ;                      // the state's row weights
  unsigned char* panel = smem + kScalarBytes;
  T* stg = reinterpret_cast<T*>(panel + panel_bytes<T>(d.T));

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16 + g;  // this thread's rows r0, r0 + 8 of a tile

  // blockIdx.x = role * (B nc slabs) + (b nc + c) slabs + slab
  const int n_slabs = d.G * d.slabs_per_group;
  const int per_role = d.B * d.nc * n_slabs;
  const int role = blockIdx.x / per_role;
  int rest = blockIdx.x - role * per_role;
  const int slab = rest % n_slabs;
  rest /= n_slabs;
  const int c = rest % d.nc, b = rest / d.nc;
  const int grp = slab / d.slabs_per_group;
  const int h_lo = grp * d.rep + (slab % d.slabs_per_group) * d.slab;
  const int nh = min(d.slab, (grp + 1) * d.rep - h_lo);
  const bool is_state = role >= 1 && role <= d.n_state;
  const int qt = role == 0 ? d.T - 1 : d.T - 1 - (role - d.n_state);
  const int half = role - 1;  // a state block's 64 rows of N

  const long long t0 = static_cast<long long>(c) * d.Q;
  const T* xb = x + b * sx.b + t0 * sx.s;
  const float* dtb = dt + b * sdt.b + t0 * sdt.s;
  const T* bb = bm + b * sb.b + t0 * sb.s + grp * sb.h;
  const T* cb = cm + b * sc.b + t0 * sc.s + grp * sc.h;

  float* sp = reinterpret_cast<float*>(panel);  // y-block: S [64][ldp]
  const int ldp = kT * d.T + 4;
  const T* bp = reinterpret_cast<const T*>(panel);  // state: B [64T][kLDB]

  if (!is_state) {
    // ---- the score panel S = C_i B_j^T, j <= i: 32 columns of N a stage
    const int nkc = (d.N + kKC - 1) / kKC;
    const int n_u = (qt + 1) * nkc;
    auto issue = [&](int u) {
      T* buf = stg + (u & 1) * 2 * kT * LDK;
      const int jt = u / nkc, k0 = (u - jt * nkc) * kKC;
      stage<T, ASYNC>(buf, LDK, kT, kKC, cb, sc.s, qt * kT, d.Q, k0, d.N);
      stage<T, ASYNC>(buf + kT * LDK, LDK, kT, kKC, bb, sb.s, jt * kT, d.Q,
                      k0, d.N);
      cp_commit();
    };
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    issue(0);
    for (int u = 0; u < n_u; ++u) {
      if (u + 1 < n_u)
        issue(u + 1);
      else
        cp_commit();
      cp_wait<1>();
      __syncthreads();
      const T* cf = stg + (u & 1) * 2 * kT * LDK + r0 * LDK + t;
      const T* bf = stg + (u & 1) * 2 * kT * LDK + kT * LDK + g * LDK + t;
#pragma unroll
      for (int k0 = 0; k0 < kKC; k0 += 8) {
        uint32_t ahi[4], alo[4], bhi[8][2], blo[8][2];
        split<kExact>(to_f32(cf[k0]), ahi[0], alo[0]);
        split<kExact>(to_f32(cf[8 * LDK + k0]), ahi[1], alo[1]);
        split<kExact>(to_f32(cf[k0 + 4]), ahi[2], alo[2]);
        split<kExact>(to_f32(cf[8 * LDK + k0 + 4]), ahi[3], alo[3]);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          split<kExact>(to_f32(bf[n * 8 * LDK + k0]), bhi[n][0], blo[n][0]);
          split<kExact>(to_f32(bf[n * 8 * LDK + k0 + 4]), bhi[n][1],
                        blo[n][1]);
        }
        mma3<8, kExact, kExact>(acc, ahi, alo, bhi, blo);
      }
      const int jt = u / nkc;
      if (u - jt * nkc == nkc - 1) {  // key tile jt's scores are complete
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = jt * kT + n * 8 + 2 * t;
          *reinterpret_cast<float2*>(sp + r0 * ldp + col) =
              make_float2(acc[n][0], acc[n][1]);
          *reinterpret_cast<float2*>(sp + (r0 + 8) * ldp + col) =
              make_float2(acc[n][2], acc[n][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
        }
      }
      __syncthreads();  // the buffer is free for the stage after next
    }
    cp_wait<0>();
  } else {
    // ---- the state block's 64 columns of B, all Q rows, with x's first
    stage<T, ASYNC>(reinterpret_cast<T*>(panel), kLDB, kT * d.T, kT, bb,
                    sb.s, 0, d.Q, half * kT, d.N);
    cp_commit();
  }

  // ---- the heads of the slab, each over its key tiles: x by stages
  const int J = is_state ? d.T : qt + 1;
  const int steps = nh * J;
  auto issue = [&](int s) {
    const int hi = s / J, jt = s - hi * J, h = h_lo + hi;
    stage<T, ASYNC>(stg + (s & 1) * kT * LDX, LDX, kT, PW, xb + h * sx.h,
                    sx.s, jt * kT, d.Q, 0, d.P);
    if (jt == 0)
      for (int i = threadIdx.x; i < d.Q; i += kThreads)
        cp_async4(dts + (hi & 1) * kMaxQ + i, dtb + h * sdt.h + i * sdt.s);
    cp_commit();
  };
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  const int gi0 = qt * kT + r0, gi1 = gi0 + 8;  // y-block: query rows
  float cs0 = 0.0f, cs1 = 0.0f;
  issue(0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps)
      issue(s + 1);
    else
      cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int hi = s / J, jt = s - hi * J, h = h_lo + hi;
    const float* dth = dts + (hi & 1) * kMaxQ;
    if (jt == 0) {  // a new head: its cumsum (and the state's row weights)
      if (warp == 0) chunk_cumsum(cs, dth, a_h[h], d.Q, lane);
      __syncthreads();
      if (is_state) {
        const float last = cs[d.Q - 1];
        for (int j = threadIdx.x; j < kT * d.T; j += kThreads)
          wst[j] = j < d.Q ? expf(last - cs[j]) * dth[j] : 0.0f;
        if (half == 0) {
          const long long cell =
              (static_cast<long long>(b) * d.nc + c) * d.H + h;
          for (int j = threadIdx.x; j < d.Q; j += kThreads)
            cs_out[cell * d.Q + j] = cs[j];
          if (threadIdx.x == 0) decay_out[cell] = expf(last);
        }
        __syncthreads();
      } else {
        cs0 = gi0 < d.Q ? cs[gi0] : 0.0f;
        cs1 = gi1 < d.Q ? cs[gi1] : 0.0f;
      }
    }
    const T* xf = stg + (s & 1) * kT * LDX + t * LDX + g;
    const int j0 = jt * kT + t;  // this thread's key column in k-step 0
    if (is_state) {
      // state[n][p] += sum_j (B_jn w_j) x_jp: A = (B w)^T from the panel
      const T* bf = bp + j0 * kLDB + r0;
      const float* wf = wst + j0;
#pragma unroll
      for (int k0 = 0; k0 < kT; k0 += 8) {
        const float w0 = wf[k0], w1 = wf[k0 + 4];
        uint32_t ahi[4], alo[4], bhi[NT][2], blo[NT][2];
        split<false>(to_f32(bf[k0 * kLDB]) * w0, ahi[0], alo[0]);
        split<false>(to_f32(bf[k0 * kLDB + 8]) * w0, ahi[1], alo[1]);
        split<false>(to_f32(bf[(k0 + 4) * kLDB]) * w1, ahi[2], alo[2]);
        split<false>(to_f32(bf[(k0 + 4) * kLDB + 8]) * w1, ahi[3], alo[3]);
        x_frags<T, NT, LDX>(xf, k0, bhi, blo);
        mma3<NT, false, kExact>(acc, ahi, alo, bhi, blo);
      }
    } else {
      // y[i][p] += sum_j W_ij x_jp; on the diagonal tile warp w's rows
      // reach only key columns < 16 (w + 1)
      const int k_end = jt == qt ? 16 * (warp + 1) : kT;
      const bool ok0 = gi0 < d.Q, ok1 = gi1 < d.Q;
      const float* s0 = sp + r0 * ldp + j0;
      const float* s1 = s0 + 8 * ldp;
      const float* csf = cs + j0;
      const float* dtf = dth + j0;
#pragma unroll
      for (int k0 = 0; k0 < kT; k0 += 8) {
        if (k0 >= k_end) break;  // warp-uniform
        const int ja = j0 + k0, jb = ja + 4;
        const float c0 = csf[k0], c1 = csf[k0 + 4];
        const float d0 = dtf[k0], d1 = dtf[k0 + 4];
        const float w00 = ok0 && ja <= gi0
            ? (s0[k0] * expf(cs0 - c0)) * d0 : 0.0f;
        const float w10 = ok1 && ja <= gi1
            ? (s1[k0] * expf(cs1 - c0)) * d0 : 0.0f;
        const float w01 = ok0 && jb <= gi0
            ? (s0[k0 + 4] * expf(cs0 - c1)) * d1 : 0.0f;
        const float w11 = ok1 && jb <= gi1
            ? (s1[k0 + 4] * expf(cs1 - c1)) * d1 : 0.0f;
        uint32_t ahi[4], alo[4], bhi[NT][2], blo[NT][2];
        split<false>(w00, ahi[0], alo[0]);
        split<false>(w10, ahi[1], alo[1]);
        split<false>(w01, ahi[2], alo[2]);
        split<false>(w11, ahi[3], alo[3]);
        x_frags<T, NT, LDX>(xf, k0, bhi, blo);
        mma3<NT, false, kExact>(acc, ahi, alo, bhi, blo);
      }
    }
    if (jt == J - 1) {  // the head is done: write its rows and start over
      if (is_state) {
        const long long cell =
            (static_cast<long long>(b) * d.nc + c) * d.H + h;
        float* st = states + cell * d.N * d.P;
        const int n0 = half * kT + r0, n1 = n0 + 8;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int p = n * 8 + 2 * t;
          if (n0 < d.N && p < d.P) st[n0 * d.P + p] = acc[n][0];
          if (n0 < d.N && p + 1 < d.P) st[n0 * d.P + p + 1] = acc[n][1];
          if (n1 < d.N && p < d.P) st[n1 * d.P + p] = acc[n][2];
          if (n1 < d.N && p + 1 < d.P) st[n1 * d.P + p + 1] = acc[n][3];
        }
      } else {
        T* y0 = y + ((b * static_cast<long long>(d.S) + t0 + gi0) * d.H + h) *
                        d.P;
        T* y1 = y0 + 8LL * d.H * d.P;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int p = n * 8 + 2 * t;
          if (gi0 < d.Q && p < d.P) y0[p] = from_f32<T>(acc[n][0]);
          if (gi0 < d.Q && p + 1 < d.P) y0[p + 1] = from_f32<T>(acc[n][1]);
          if (gi1 < d.Q && p < d.P) y1[p] = from_f32<T>(acc[n][2]);
          if (gi1 < d.Q && p + 1 < d.P) y1[p + 1] = from_f32<T>(acc[n][3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    }
    __syncthreads();  // the buffer is free for the stage after next
  }
  cp_wait<0>();
}

template <typename T, int PW, bool ASYNC>
int launch(const void* x, const float* dt, const float* a_h, const void* bm,
           const void* cm, void* y, float* states, float* cs, float* decay,
           const long long* st, Dims d, cudaStream_t stream) {
  auto kernel = ssd_chunk_tc_kernel<T, PW, ASYNC>;
  const size_t bytes =
      kScalarBytes + panel_bytes<T>(d.T) + 2 * stage_half_bytes<T, PW>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(d.T + d.n_state) * d.B *
                           d.nc * d.G * d.slabs_per_group;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sx{st[0], st[1], st[2]}, sdt{st[3], st[4], st[5]},
      sb{st[6], st[7], st[8]}, sc{st[9], st[10], st[11]};
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, a_h, static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(y), states, cs, decay, sx,
      sdt, sb, sc, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_p(int async_copy, const void* x, const float* dt,
             const float* a_h, const void* bm, const void* cm, void* y,
             float* states, float* cs, float* decay, const long long* st,
             Dims d, cudaStream_t s) {
  if (d.P <= 64)
    return async_copy ? launch<T, 64, true>(x, dt, a_h, bm, cm, y, states,
                                            cs, decay, st, d, s)
                      : launch<T, 64, false>(x, dt, a_h, bm, cm, y, states,
                                             cs, decay, st, d, s);
  return async_copy ? launch<T, 128, true>(x, dt, a_h, bm, cm, y, states, cs,
                                           decay, st, d, s)
                    : launch<T, 128, false>(x, dt, a_h, bm, cm, y, states,
                                            cs, decay, st, d, s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, bm, cm and y). async_copy: 1 when x,
// bm and cm all take 16-byte copies (16-byte aligned addresses, strides
// and rows), else 0. slab: heads per block (at most H / G are used).
// strides: three (batch, position, head-or-group) element strides each
// for x, dt, bm, cm. Returns cudaErrorInvalidValue for a dtype or size it
// does not take; the caller checks shapes, devices and the unit stride of
// the last axis.
extern "C" int ssd_chunk_tc_fwd(int dtype, int async_copy, int slab,
                                const void* x, const float* dt,
                                const float* a_h, const void* bm,
                                const void* cm, void* y, float* states,
                                float* cs, float* decay,
                                const long long* strides, int B, int S, int H,
                                int G, int P, int N, int Q, void* stream) {
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || P < 1 || P > 128 ||
      G < 1 || H % G != 0 || S % Q != 0 || slab < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Dims d;
  d.B = B;
  d.S = S;
  d.H = H;
  d.G = G;
  d.P = P;
  d.N = N;
  d.Q = Q;
  d.nc = S / Q;
  d.T = (Q + kT - 1) / kT;
  d.rep = H / G;
  d.slab = slab < d.rep ? slab : d.rep;
  d.slabs_per_group = (d.rep + d.slab - 1) / d.slab;
  d.n_state = (N + kT - 1) / kT;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_p<float>(async_copy, x, dt, a_h, bm, cm, y, states, cs,
                           decay, strides, d, s);
  if (dtype == 1)
    return launch_p<__nv_bfloat16>(async_copy, x, dt, a_h, bm, cm, y,
                                   states, cs, decay, strides, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
