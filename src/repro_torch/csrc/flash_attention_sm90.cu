// Flash attention (K2) on Hopper's tensor cores (sm_90a) for bf16 inputs:
// the forward and both halves of the backward (dK/dV, dQ), products by
// wgmma, tiles loaded by TMA. The backward's dK/dV kernel and its D_i
// pre-pass are described after the forward, above flash_bwd_delta_kernel;
// the dQ kernel after them, above flash_bwd_dq_tc_kernel.
//
// Replaces, for bf16 inputs, the forward of the Pallas kernel
// src/repro/kernels/flash_attention.py::flash_attention (:88, body
// _flash_kernel :37). It computes the function that flash_fwd_kernel in
// flash_attention.cu computes, with the same masks and the same online
// softmax in float32. Per query row at position qpos = q_offset + s and
// key position kpos:
//
//     valid = kpos < T && (!causal || kpos <= qpos)
//             && (!window || qpos - kpos < window)
//     s     = valid ? (q . k) * D^-1/2 : NEG_INF        (NEG_INF = -1e30)
//     o     = softmax(s) v,   lse = m + log(max(l, 1e-30))
//
// m starts at -inf, the correction is exp(m_prev - m_cur), l is clamped at
// 1e-30 before the division. One rounding point is new: P = exp(s - m) is
// rounded to bf16 before P.V, because the tensor cores take bf16 operands;
// l sums the float32 values. Query head h reads kv head h / (H / Hkv).
// The output is written in q's layout through its strides; lse is a
// contiguous (B, H, S) float32 array, which the backward kernels read.
//
// Bound at the zoo path's shape (B 8, H 28, Hkv 4, S = T = 1023, D 128,
// causal): 4 B H D S(S+1)/2 = 6.0e10 FLOP against 135 MB moved, so
// operations bound it: 0.061 ms at the bf16 tensor-core peak of 989
// TFLOP/s. The CUDA-core forward runs the same products as float32 FMAs.
//
// Design, the plainest that reaches the tensor cores:
// - One block of one warpgroup (128 threads) per (64 query rows, head,
//   batch); the grid runs the q-tiles with the most key tiles first. The
//   key tiles run in a loop over the range key_tiles() gives; tiles above
//   the diagonal or outside the window are skipped, which is exact only
//   because the wrapper refuses rows with no valid key.
// - Loads: 4-d TMA tensor maps over the strided (B, H, S, D) views (dims
//   D, S, H, B), boxes of 64 rows x 64 elements (128 bytes, the 128-byte
//   swizzle's width), so a D = 128 row is two swizzle atoms. Rows past S or
//   T are zero-filled by TMA and masked anyway. Q is loaded once; K and V
//   go through a two-stage ring, one mbarrier per stage with expect_tx
//   bytes and a parity per round: thread 0 issues tile j+1 while the
//   warpgroup computes tile j, and one __syncthreads() per tile frees the
//   stage the next load overwrites.
// - S = Q K^T: wgmma m64n64k16, both operands K-major in shared memory
//   (128-byte swizzle), D/16 k-steps.
// - Softmax on the accumulator in registers: each thread holds rows r and
//   r+8 of its warp's 16-row slab, and the row reductions are quad
//   shuffles. No score tile goes to shared memory.
// - O += P V: P rounded to bf16 straight into the A-register fragment of a
//   wgmma m64nDk16 (the accumulator's layout is the A fragment's); V read
//   from shared memory MN-major through the transpose bit. O's float32
//   accumulator is rescaled by the correction before the product.
// - Epilogue: O / max(l, 1e-30) and lse written with plain stores.
// Later work that makes it fast: a producer warp, two consumer
// warpgroups sharing K/V tiles, persistent blocks, exp2 with a folded
// scale, overlapping the softmax with the next product.
//
// Shared memory (from a 1024-byte-aligned base): Q, then the K stages,
// then the V stages, each 64 x D bf16 = D x 128 bytes: 80 KB at D = 128,
// two blocks per SM. The host side encodes the tensor maps per call with
// cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint so the
// library needs no -lcuda, opts into the dynamic shared memory, and
// returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per tile
constexpr int kThreads = 128;           // one warpgroup
constexpr int kStages = 2;              // depth of a tile ring
constexpr int kAtom = 64;               // bf16 elements in a 128-byte row
constexpr int kBoxBytes = kBQ * 128;    // one 64-row x 64-element box
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;
};

struct Problem {
  int B, H, Hkv, S, T;
  int causal, has_window, window, q_offset;
  float scale;
};

// ----------------------------------------------- masks (as flash_attention.cu)

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

// ------------------------------------------------------ mbarrier and TMA

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-d tensor map into shared memory, counted on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(row),
      "r"(head), "r"(batch)
      : "memory");
}

// ---------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets (in 16-byte units), layout type 1.
// K-major: SBO = 1024 (the next 8 rows), LBO unused (1). MN-major: LBO =
// the next 64 MN elements, SBO = 1024 (the next 8 rows of K).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Orders the compiler's reads and writes of accumulator registers against
// the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define K2_F4(i) "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), \
                 "+f"(d[(i) + 3])
#define K2_F16(i) K2_F4(i), K2_F4((i) + 4), K2_F4((i) + 8), K2_F4((i) + 12)
#define K2_F32(i) K2_F16(i), K2_F16((i) + 16)

#define K2_D32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define K2_D64                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) B^T (64 x 16, smem,
// K-major); d is read only when accumulate != 0.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " K2_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : K2_F32(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N, f32) += A (64 x 16, bf16 registers) B (16 x N, smem, MN-major
// through the transpose bit).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " K2_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : K2_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " K2_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : K2_F32(0), K2_F32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef K2_F4
#undef K2_F16
#undef K2_F32
#undef K2_D32
#undef K2_D64

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// --------------------------------------------------------------- kernel

template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return (D / kAtom) * kBoxBytes;  // one 64-row tile of Q, K or V
}

template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return (1 + 2 * kStages) * tile_bytes<D>() + 1024;  // + alignment slack
}

// Issue the TMA loads of one 64-row tile (D / 64 boxes) at (row, head,
// batch) into dst, counted on bar.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int row, int head,
                                          int batch) {
#pragma unroll
  for (int half = 0; half < D / kAtom; ++half)
    tma_load(dst + half * kBoxBytes, map, bar, half * kAtom, row, head,
             batch);
}

// The j-th tile pair of a ring into stage j % kStages: the 64-row tiles at
// (row, head, batch) of map ta into ring sa and of map tb into ring sb,
// counted on the stage's barrier (bars + 8 * stage).
template <int D>
__device__ __forceinline__ void load_stage(uint32_t sa, uint32_t sb,
                                           const CUtensorMap* ta,
                                           const CUtensorMap* tb,
                                           uint32_t bars, int j, int row,
                                           int head, int batch) {
  constexpr int kTile = tile_bytes<D>();
  const int st = j % kStages;
  const uint32_t bar = bars + 8 * st;
  mbar_expect_tx(bar, 2 * kTile);
  load_tile<D>(sa + st * kTile, ta, bar, row, head, batch);
  load_tile<D>(sb + st * kTile, tb, bar, row, head, batch);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        __nv_bfloat16* __restrict__ o,
                        float* __restrict__ lse, Strides so, Problem p) {
  constexpr int kTile = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + kStages];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = base + kTile;                  // + stage * kTile
  const uint32_t sv = base + (1 + kStages) * kTile;  // + stage * kTile
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_kv = smem_u32(&bars[1]);        // + stage * 8

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  int kt0, kt1;
  key_tiles(p, q0, &kt0, &kt1);
  const int n = kt1 - kt0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) mbar_init(bar_kv + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, kTile);
    load_tile<D>(sq, &tq, bar_q, q0, h, b);
    for (int j = 0; j < kStages - 1 && j < n; ++j)
      load_stage<D>(sk, sv, &tk, &tv, bar_kv, j, (kt0 + j) * kBK, hk, b);
  }
  __syncwarp();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m_row[2] = {-INFINITY, -INFINITY}, l_row[2] = {0.0f, 0.0f};

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n; ++it) {
    // the stage of tile it + kStages - 1 was freed by the last iteration's
    // __syncthreads()
    if (tid == 0 && it + kStages - 1 < n)
      load_stage<D>(sk, sv, &tk, &tv, bar_kv, it + kStages - 1,
                    (kt0 + it + kStages - 1) * kBK, hk, b);
    __syncwarp();
    const int st = it % kStages;
    mbar_wait(bar_kv + 8 * st, (it / kStages) & 1);
    const int k0 = (kt0 + it) * kBK;

    // S = Q K^T over D / 16 k-steps; a k-step inside a 128-byte swizzle
    // row advances the start address by 32 bytes
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_n64(s, sw128_desc(sq + off, 16, 1024),
                   sw128_desc(sk + st * kTile + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // s[4i + j]: row row0 + 8 (j / 2), key k0 + 8 i + 2 t4 + j % 2
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = row0 + 8 * (j / 2), col = k0 + 8 * i + 2 * t4 + j % 2;
        s[4 * i + j] = is_valid(p, row, col) ? s[4 * i + j] * p.scale
                                             : kNegInf;
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        mx = fmaxf(mx, fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_cur = fmaxf(m_row[r], mx);
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float e = expf(s[4 * i + 2 * r + c] - m_cur);
          s[4 * i + 2 * r + c] = e;
          sum += e;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      corr[r] = expf(m_row[r] - m_cur);
      l_row[r] = l_row[r] * corr[r] + sum;
      m_row[r] = m_cur;
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[4 * i] *= corr[0];
      acc[4 * i + 1] *= corr[0];
      acc[4 * i + 2] *= corr[1];
      acc[4 * i + 3] *= corr[1];
    }

    // P as the A fragment, one 16-key slice per k-step: register j holds
    // (row g + 8 (j % 2), keys 16 kk + 8 (j / 2) + 2 t4, +1), which are
    // s[8 kk + 2 j] and s[8 kk + 2 j + 1]
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);

    // O += P V; a k-step is 16 keys = 2048 bytes of V
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(acc, a[kk],
                  sw128_desc(sv + st * kTile + kk * 2048, kBoxBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();  // every warp is done with this stage
  }

  __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.S) continue;
    const float l = fmaxf(l_row[r], 1e-30f);
    __nv_bfloat16* orow = ob + static_cast<long long>(row) * so.s + 2 * t4;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
          __floats2bfloat162_rn(acc[4 * i + 2 * r] / l,
                                acc[4 * i + 2 * r + 1] / l);
    if (t4 == 0)
      lse[(static_cast<long long>(b) * p.H + h) * p.S + row] =
          m_row[r] + logf(l);
  }
}

// ------------------------------------------------------ backward: dK, dV
//
// dK and dV of the forward above, for bf16 inputs: what flash_bwd_dkdv_kernel
// in flash_attention.cu computes (the TPU kernel has no backward), with the
// same masks, NEG_INF and the forward's lse. Per valid (query row, key):
//
//     P  = exp(s * scale - lse),   dP = dO . v,   dS = P (dP - D_i)
//     dV = sum over the group's query rows of P dO
//     dK = scale * sum of dS q,    D_i = sum_d dO_id O_id
//
// and P = dS = 0 where the mask holds. Two rounding points are new: P and
// dS are rounded to bf16 before their products, as the forward rounds P.
//
// Bound at the zoo path's shape (B 8, H 28, Hkv 4, S = T = 1023, D 128,
// causal): four products of 2 D FLOP per valid pair and head, 8 B H D
// S(S+1)/2 = 1.2e11 FLOP against 100 MB moved, so operations bound it:
// 0.121 ms at the bf16 tensor-core peak of 989 TFLOP/s.
//
// Design: keys on wgmma's M dimension, so all four products take the
// forward's operand layouts.
// - flash_bwd_delta_kernel first writes D_i, a (B, H, S) float32 array,
//   one warp per query row, so no key tile recomputes it; the dQ kernel
//   below reads the same array.
// - One block of one warpgroup per (64-key tile, kv head, batch), the
//   lowest key tiles (under a causal mask, the ones most query tiles see)
//   first. K and V are loaded once by TMA; the block loops over the
//   (query head of the group, query tile) pairs that query_tiles() says
//   meet its keys. Q and dO go through a two-stage ring, one mbarrier per
//   stage, as the forward's K/V ring; the 64 lse and D_i values of a pair
//   are read into registers one pair ahead and stored into the stage's
//   slot of a small shared array before the iteration's closing
//   __syncthreads().
// - S^T = K Q^T and dP^T = V dO^T: wgmma m64n64k16, both operands K-major,
//   as the forward's Q K^T. The accumulators' rows are keys, their columns
//   query rows.
// - P^T and dS^T in registers, masked per (key, query row); each rounded
//   to bf16 straight into an A fragment.
// - dV += P^T dO and dK += dS^T Q: wgmma m64nDk16 with A from registers and
//   B read MN-major through the transpose bit, as the forward's P V.
// - dK and dV stay float32 in registers for the whole block (D / 2 each a
//   thread); the epilogue scales dK, rounds both to bf16 and stores them
//   through their strides, rows past T left alone.
//
// Shared memory (from a 1024-byte-aligned base): K, V, two stages of Q and
// two of dO, each D x 128 bytes: 96 KB at D = 128, two blocks per SM.

// D_i = sum_d dO_id O_id in float32 for every query row of o and dout
// (bf16, (batch, head, row) element strides, unit stride on d, each row
// on 4 bytes), into delta, a contiguous (B, H, S) array. One warp per
// row; a lane reads bf16 pairs, the warp sums by shuffles.
__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                           const __nv_bfloat16* __restrict__ dout,
                           float* __restrict__ delta, Strides so,
                           Strides sd, int H, int S, int D,
                           long long rows) {
  const long long r =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (r >= rows) return;  // the whole warp
  const int lane = threadIdx.x % 32;
  const long long s = r % S, h = (r / S) % H;
  const long long b = r / (static_cast<long long>(S) * H);
  const __nv_bfloat16* orow = o + b * so.b + h * so.h + s * so.s;
  const __nv_bfloat16* drow = dout + b * sd.b + h * sd.h + s * sd.s;
  float sum = 0.0f;
  for (int c = 2 * lane; c < D; c += 64) {
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(orow + c));
    const float2 y = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(drow + c));
    sum = fmaf(x.x, y.x, sum);
    sum = fmaf(x.y, y.y, sum);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[r] = sum;
}

// The query tiles [begin, end) that hold a valid query row for some key of
// the key tile starting at k0 (the counterpart of key_tiles; empty when no
// row sees these keys).
__device__ __forceinline__ void query_tiles(const Problem& p, int k0,
                                            int* begin, int* end) {
  const int nq = (p.S + kBQ - 1) / kBQ;
  const int k_hi = min(k0 + kBK, p.T) - 1;
  int b = 0, e = nq;
  if (p.causal) {  // row r sees key k0 iff r + q_offset >= k0
    const int lo = k0 - p.q_offset;
    b = lo > 0 ? min(lo / kBQ, nq) : 0;
  }
  if (p.has_window) {  // the newest row that sees key k_hi
    const int hi = k_hi + p.window - 1 - p.q_offset;
    e = hi < 0 ? 0 : min(nq, hi / kBQ + 1);
  }
  *begin = b;
  *end = max(b, e);
}

template <int D>
__host__ __device__ constexpr int bwd_smem_bytes() {
  return (2 + 2 * kStages) * tile_bytes<D>() + 1024;  // + alignment slack
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, Strides sdk,
                             Strides sdv, Problem p) {
  constexpr int kTile = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + kStages];
  __shared__ float rows_s[kStages][2][kBQ];  // a stage's lse and D_i

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = base;
  const uint32_t sv = base + kTile;
  const uint32_t sq = base + 2 * kTile;               // + stage * kTile
  const uint32_t sdo = base + (2 + kStages) * kTile;  // + stage * kTile
  const uint32_t bar_kv = smem_u32(&bars[0]);
  const uint32_t bar_qd = smem_u32(&bars[1]);         // + stage * 8

  const int k0 = blockIdx.x * kBK;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int g = p.H / p.Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t4 = lane % 4;
  const int key0 = k0 + warp * 16 + gr;  // this thread's keys: key0, key0 + 8
  int qt0, qt1;
  query_tiles(p, k0, &qt0, &qt1);
  const int nqt = qt1 - qt0;
  const int n = g * nqt;  // (query head, query tile) pairs, head-major

  // pair j: its query head and first row; then the value thread tid keeps
  // of it, lse (tid < 64) or D_i (tid >= 64) of row tid % 64, 0 past S
  auto head_of = [&](int j) { return hk * g + j / nqt; };
  auto row0_of = [&](int j) { return (qt0 + j % nqt) * kBQ; };
  auto row_value = [&](int j) {
    const int row = row0_of(j) + tid % kBQ;
    if (row >= p.S) return 0.0f;
    const float* src = tid < kBQ ? lse : delta;
    return src[(static_cast<long long>(b) * p.H + head_of(j)) * p.S + row];
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < kStages; ++st) mbar_init(bar_qd + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * kTile);
    load_tile<D>(sk, &tk, bar_kv, k0, hk, b);
    load_tile<D>(sv, &tv, bar_kv, k0, hk, b);
    for (int j = 0; j < kStages - 1 && j < n; ++j)
      load_stage<D>(sq, sdo, &tq, &tdo, bar_qd, j, row0_of(j), head_of(j), b);
  }
  if (n > 0) rows_s[0][tid / kBQ][tid % kBQ] = row_value(0);
  __syncthreads();

  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.0f;

  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n; ++it) {
    // the stage of pair it + kStages - 1 was freed by the last iteration's
    // __syncthreads()
    if (tid == 0 && it + kStages - 1 < n) {
      const int j = it + kStages - 1;
      load_stage<D>(sq, sdo, &tq, &tdo, bar_qd, j, row0_of(j), head_of(j), b);
    }
    __syncwarp();
    const float next = it + 1 < n ? row_value(it + 1) : 0.0f;
    const int st = it % kStages;
    mbar_wait(bar_qd + 8 * st, (it / kStages) & 1);
    const int q0 = row0_of(it);
    const uint32_t sq_st = sq + st * kTile, sdo_st = sdo + st * kTile;

    // S^T = K Q^T and dP^T = V dO^T over D / 16 k-steps each
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_n64(s, sw128_desc(sk + off, 16, 1024),
                   sw128_desc(sq_st + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_n64(dp, sw128_desc(sv + off, 16, 1024),
                   sw128_desc(sdo_st + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // s[4i + j]: key key0 + 8 (j / 2), query row q0 + 8 i + 2 t4 + j % 2;
    // P^T into s, dS^T into dp
    const float* lse_s = rows_s[st][0];
    const float* d_s = rows_s[st][1];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 8 * i + 2 * t4 + j % 2;
        const float pr = is_valid(p, q0 + c, key0 + 8 * (j / 2))
                             ? expf(s[4 * i + j] * p.scale - lse_s[c])
                             : 0.0f;
        s[4 * i + j] = pr;
        dp[4 * i + j] = pr * (dp[4 * i + j] - d_s[c]);
      }

    // P^T and dS^T as A fragments, one 16-row slice of the query tile per
    // k-step (the forward's P layout: register j holds keys gr + 8 (j % 2),
    // query rows 16 kk + 8 (j / 2) + 2 t4, +1)
    uint32_t ap[4][4], ads[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ap[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
        ads[kk][j] = pack_bf16(dp[8 * kk + 2 * j], dp[8 * kk + 2 * j + 1]);
      }

    // dV += P^T dO and dK += dS^T Q; a k-step is 16 query rows = 2048 bytes
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(acc_dv, ap[kk],
                  sw128_desc(sdo_st + kk * 2048, kBoxBytes, 1024));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(acc_dk, ads[kk],
                  sw128_desc(sq_st + kk * 2048, kBoxBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    // the slot of pair it + 1 was last read in iteration it - 1
    if (it + 1 < n) rows_s[(it + 1) % kStages][tid / kBQ][tid % kBQ] = next;
    __syncthreads();  // every warp is done with this stage
  }

  __nv_bfloat16* dkb = dk + b * sdk.b + hk * sdk.h;
  __nv_bfloat16* dvb = dv + b * sdv.b + hk * sdv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= p.T) continue;
    __nv_bfloat16* krow = dkb + static_cast<long long>(key) * sdk.s + 2 * t4;
    __nv_bfloat16* vrow = dvb + static_cast<long long>(key) * sdv.s + 2 * t4;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(krow + 8 * i) =
          __floats2bfloat162_rn(acc_dk[4 * i + 2 * r] * p.scale,
                                acc_dk[4 * i + 2 * r + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * i) =
          __floats2bfloat162_rn(acc_dv[4 * i + 2 * r],
                                acc_dv[4 * i + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------- backward: dQ
//
// dQ of the forward above, for bf16 inputs: what flash_bwd_dq_kernel in
// flash_attention.cu computes, with the same masks, NEG_INF, the forward's
// lse and the caller's scale. Per valid (query row, key):
//
//     P  = exp(s * scale - lse),   dP = dO . v,   dS = P (dP - D_i)
//     dQ = scale * sum over the row's keys of dS k
//
// and P = dS = 0 where the mask holds. One rounding point is new: dS is
// rounded to bf16 before dS K, as the dK/dV kernel rounds dS^T. D_i comes
// from flash_bwd_delta_kernel, written once per backward for both halves.
//
// Bound at the zoo path's shape (B 8, H 28, Hkv 4, S = T = 1023, D 128,
// causal): three products of 2 D FLOP per valid pair and head, 6 B H D
// S(S+1)/2 = 9.0e10 FLOP against 195 MB moved (q, dO and dq; k and v; lse
// and D_i), so operations bound it: 0.091 ms at the bf16 tensor-core peak
// of 989 TFLOP/s.
//
// Design: the forward's, with one more product and the queries on wgmma's
// M dimension. One block of one warpgroup per (64 query rows, head,
// batch), the q-tiles with the most key tiles first. Q and dO are loaded
// once by TMA on one barrier, K and V go through the forward's two-stage
// ring over the key tiles key_tiles() gives. Each thread keeps lse and D_i
// of its two rows in registers, read once.
// - S = Q K^T and dP = dO V^T: wgmma m64n64k16, both operands K-major,
//   one commit for both.
// - P and dS in registers with the forward's accumulator indexing; dS
//   rounded to bf16 straight into the A fragment, as the forward's P.
// - dQ += dS K: wgmma m64nDk16, K read MN-major through the transpose bit
//   (the forward's P V descriptor with K in V's place), so one K stage
//   serves as K-major B for S and as MN-major B for dQ.
// - dQ stays float32 in registers (D / 2 a thread); the epilogue scales
//   it, rounds it to bf16 and stores it through dq's strides, rows past S
//   left alone. No atomics: the result does not depend on scheduling.
// Later work: fusing dQ into the dK/dV kernel with float32 atomics
// (FlashAttention-3's scheme) saves recomputing S and dP but makes dQ
// depend on the run order.
//
// Shared memory: Q, dO, two stages of K and two of V, each D x 128 bytes:
// 96 KB at D = 128 (bwd_smem_bytes), two blocks per SM.

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dq, Strides sdq,
                           Problem p) {
  constexpr int kTile = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + kStages];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sdo = base + kTile;
  const uint32_t sk = base + 2 * kTile;               // + stage * kTile
  const uint32_t sv = base + (2 + kStages) * kTile;   // + stage * kTile
  const uint32_t bar_qd = smem_u32(&bars[0]);
  const uint32_t bar_kv = smem_u32(&bars[1]);         // + stage * 8

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  int kt0, kt1;
  key_tiles(p, q0, &kt0, &kt1);
  const int n = kt1 - kt0;

  if (tid == 0) {
    mbar_init(bar_qd, 1);
    for (int st = 0; st < kStages; ++st) mbar_init(bar_kv + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_qd, 2 * kTile);
    load_tile<D>(sq, &tq, bar_qd, q0, h, b);
    load_tile<D>(sdo, &tdo, bar_qd, q0, h, b);
    for (int j = 0; j < kStages - 1 && j < n; ++j)
      load_stage<D>(sk, sv, &tk, &tv, bar_kv, j, (kt0 + j) * kBK, hk, b);
  }
  __syncwarp();

  // lse and D_i of rows row0 and row0 + 8; 0 past S, where every pair is
  // masked
  float lse_r[2], d_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long at = (static_cast<long long>(b) * p.H + h) * p.S + row;
    lse_r[r] = row < p.S ? lse[at] : 0.0f;
    d_r[r] = row < p.S ? delta[at] : 0.0f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

  mbar_wait(bar_qd, 0);
  for (int it = 0; it < n; ++it) {
    // the stage of tile it + kStages - 1 was freed by the last iteration's
    // __syncthreads()
    if (tid == 0 && it + kStages - 1 < n)
      load_stage<D>(sk, sv, &tk, &tv, bar_kv, it + kStages - 1,
                    (kt0 + it + kStages - 1) * kBK, hk, b);
    __syncwarp();
    const int st = it % kStages;
    mbar_wait(bar_kv + 8 * st, (it / kStages) & 1);
    const int k0 = (kt0 + it) * kBK;
    const uint32_t sk_st = sk + st * kTile, sv_st = sv + st * kTile;

    // S = Q K^T and dP = dO V^T over D / 16 k-steps each
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_n64(s, sw128_desc(sq + off, 16, 1024),
                   sw128_desc(sk_st + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_n64(dp, sw128_desc(sdo + off, 16, 1024),
                   sw128_desc(sv_st + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // s[4i + j]: row row0 + 8 (j / 2), key k0 + 8 i + 2 t4 + j % 2; dS
    // into dp
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j / 2, col = k0 + 8 * i + 2 * t4 + j % 2;
        const float pr = is_valid(p, row0 + 8 * r, col)
                             ? expf(s[4 * i + j] * p.scale - lse_r[r])
                             : 0.0f;
        dp[4 * i + j] = pr * (dp[4 * i + j] - d_r[r]);
      }

    // dS as the A fragment, one 16-key slice per k-step (the forward's P
    // layout)
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a[kk][j] = pack_bf16(dp[8 * kk + 2 * j], dp[8 * kk + 2 * j + 1]);

    // dQ += dS K; a k-step is 16 keys = 2048 bytes of K
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(acc, a[kk],
                  sw128_desc(sk_st + kk * 2048, kBoxBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();  // every warp is done with this stage
  }

  __nv_bfloat16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.S) continue;
    __nv_bfloat16* qrow = dqb + static_cast<long long>(row) * sdq.s + 2 * t4;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * i) =
          __floats2bfloat162_rn(acc[4 * i + 2 * r] * p.scale,
                                acc[4 * i + 2 * r + 1] * p.scale);
  }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (batch, head, row, D) bf16 view with element strides st = (b, h, s)
// and a unit stride on D, as a 4-d map (D, rows, heads, batch) of 64 x 64
// boxes, 128-byte swizzled, rows past the end filled with zeros.
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int d,
                int rows, int heads, int batch, const long long* st) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {kAtom, kBQ, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, void* o, float* lse, Strides so,
           Problem p, cudaStream_t stream) {
  const int bytes = smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.S + kBQ - 1) / kBQ, p.H, p.B);
  flash_fwd_tc_kernel<D><<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, so, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkdv(const CUtensorMap& tq, const CUtensorMap& tk,
                const CUtensorMap& tv, const CUtensorMap& tdo,
                const float* lse, const float* delta, void* dk, void* dv,
                Strides sdk, Strides sdv, Problem p, cudaStream_t stream) {
  const int bytes = bwd_smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.T + kBK - 1) / kBK, p.Hkv, p.B);
  flash_bwd_dkdv_tc_kernel<D><<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), sdk, sdv, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const CUtensorMap& tq, const CUtensorMap& tk,
              const CUtensorMap& tv, const CUtensorMap& tdo,
              const float* lse, const float* delta, void* dq, Strides sdq,
              Problem p, cudaStream_t stream) {
  const int bytes = bwd_smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.S + kBQ - 1) / kBQ, p.H, p.B);
  flash_bwd_dq_tc_kernel<D><<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dq), sdq, p);
  return static_cast<int>(cudaGetLastError());
}

// The tensor maps of q, k, v and dout for a backward kernel, from their
// (batch, head, position) element strides in that order.
CUresult encode_backward(EncodeTiled fn, CUtensorMap (&maps)[4],
                         const void* q, const void* k, const void* v,
                         const void* dout, int head_dim,
                         const long long* strides, int B, int H, int Hkv,
                         int S, int T) {
  CUresult r = encode(fn, &maps[0], q, head_dim, S, H, B, strides);
  if (r == CUDA_SUCCESS) r = encode(fn, &maps[1], k, head_dim, T, Hkv, B,
                                    strides + 3);
  if (r == CUDA_SUCCESS) r = encode(fn, &maps[2], v, head_dim, T, Hkv, B,
                                    strides + 6);
  if (r == CUDA_SUCCESS) r = encode(fn, &maps[3], dout, head_dim, S, H, B,
                                    strides + 9);
  return r;
}

}  // namespace

// bf16 only. head_dim: 64 or 128. strides: three (batch, head, position)
// element strides for q, k, v and o in that order; the caller checks that
// the head dimension is contiguous, that q, k and v start on 16 bytes and
// that their strides are multiples of 16 bytes (TMA's rules), and the
// shapes. Returns cudaErrorInvalidValue for a head_dim it does not take,
// cudaErrorNotSupported when the driver has no cuTensorMapEncodeTiled,
// minus the CUresult when a tensor map cannot be encoded, else the
// launch's cudaGetLastError().
extern "C" int flash_attention_fwd_tc(int head_dim, const void* q,
                                      const void* k, const void* v, void* o,
                                      float* lse, const long long* strides,
                                      int B, int H, int Hkv, int S, int T,
                                      int causal, int has_window, int window,
                                      int q_offset, float scale,
                                      void* stream) {
  if (head_dim != 64 && head_dim != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  CUresult r = encode(fn, &tq, q, head_dim, S, H, B, strides);
  if (r == CUDA_SUCCESS) r = encode(fn, &tk, k, head_dim, T, Hkv, B,
                                    strides + 3);
  if (r == CUDA_SUCCESS) r = encode(fn, &tv, v, head_dim, T, Hkv, B,
                                    strides + 6);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  const Strides so = {strides[9], strides[10], strides[11]};
  const Problem p = {B,      H,          Hkv,    S,        T,
                     causal, has_window, window, q_offset, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch<64>(tq, tk, tv, o, lse, so, p, st);
  return launch<128>(tq, tk, tv, o, lse, so, p, st);
}

// bf16 only. head_dim: 64 or 128. o and dout: (B, H, S, head_dim) with the
// element strides (batch, head, position) of o then dout; the caller checks
// the unit stride on head_dim and that each row starts on 4 bytes. delta:
// a contiguous (B, H, S) float32 array. Returns cudaErrorInvalidValue for
// a head_dim it does not take, else the launch's cudaGetLastError().
extern "C" int flash_attention_bwd_delta(int head_dim, const void* o,
                                         const void* dout, float* delta,
                                         const long long* strides, int B,
                                         int H, int S, void* stream) {
  if (head_dim != 64 && head_dim != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * H * S;
  const int per_block = kThreads / 32;
  const unsigned blocks =
      static_cast<unsigned>((rows + per_block - 1) / per_block);
  const Strides so = {strides[0], strides[1], strides[2]};
  const Strides sd = {strides[3], strides[4], strides[5]};
  flash_bwd_delta_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), delta, so, sd, H, S,
      head_dim, rows);
  return static_cast<int>(cudaGetLastError());
}

// bf16 only. head_dim: 64 or 128. strides: three (batch, head, position)
// element strides for q, k, v, dout, dk and dv in that order; lse (from
// the forward) and delta (flash_attention_bwd_delta's) are contiguous
// (B, H, S) float32. The caller checks shapes and TMA's rules for q, k, v
// and dout, as for flash_attention_fwd_tc. Returns what that function
// returns.
extern "C" int flash_attention_bwd_dkdv_tc(
    int head_dim, const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, void* dk,
    void* dv, const long long* strides, int B, int H, int Hkv, int S, int T,
    int causal, int has_window, int window, int q_offset, float scale,
    void* stream) {
  if (head_dim != 64 && head_dim != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap m[4];
  const CUresult r = encode_backward(fn, m, q, k, v, dout, head_dim, strides,
                                     B, H, Hkv, S, T);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  const Strides sdk = {strides[12], strides[13], strides[14]};
  const Strides sdv = {strides[15], strides[16], strides[17]};
  const Problem p = {B,      H,          Hkv,    S,        T,
                     causal, has_window, window, q_offset, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_dkdv<64>(m[0], m[1], m[2], m[3], lse, delta, dk, dv, sdk,
                           sdv, p, st);
  return launch_dkdv<128>(m[0], m[1], m[2], m[3], lse, delta, dk, dv, sdk,
                          sdv, p, st);
}

// bf16 only. head_dim: 64 or 128. strides: three (batch, head, position)
// element strides for q, k, v, dout and dq in that order; lse and delta as
// for flash_attention_bwd_dkdv_tc. The caller checks shapes and TMA's
// rules for q, k, v and dout. Returns what flash_attention_fwd_tc returns.
extern "C" int flash_attention_bwd_dq_tc(
    int head_dim, const void* q, const void* k, const void* v,
    const void* dout, const float* lse, const float* delta, void* dq,
    const long long* strides, int B, int H, int Hkv, int S, int T,
    int causal, int has_window, int window, int q_offset, float scale,
    void* stream) {
  if (head_dim != 64 && head_dim != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap m[4];
  const CUresult r = encode_backward(fn, m, q, k, v, dout, head_dim, strides,
                                     B, H, Hkv, S, T);
  if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  const Strides sdq = {strides[12], strides[13], strides[14]};
  const Problem p = {B,      H,          Hkv,    S,        T,
                     causal, has_window, window, q_offset, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_dq<64>(m[0], m[1], m[2], m[3], lse, delta, dq, sdq, p, st);
  return launch_dq<128>(m[0], m[1], m[2], m[3], lse, delta, dq, sdq, p, st);
}
