// Mixed-precision SGD with momentum, gated and in place, for Hopper
// (sm_90a): one launch lands one cell's update over all of its leaves.
//
// Replaces no Pallas kernel: the reference's zoo update is plain jnp
// (optim/sgd.py and the master-copy cast in train/zoo_program.py), which
// XLA fuses into one pass. Eager PyTorch ran it as six elementwise
// kernels a leaf (the gradient's cast up, momentum * v, + g, lr * v',
// m - ..., the low-precision refresh), and the engine's gate then wrote
// every leaf of the carry twice more (a where and a copy). For every
// element of every leaf of one (scenario, seed) cell's carry:
//
//     g32 = float(g)                      g in p's dtype, or float32
//     v'  = fl(fl(momentum * v) + g32)    momentum v, float32
//     m'  = fl(m - fl(lr * v'))           master m, float32
//     p'  = m' rounded to nearest even to bf16, or m' for a float32 leaf
//     (v, m, p) = running ? (v', m', p') : (v, m, p)
//
// Bound: memory. A bf16 leaf reads g (2 bytes), v and m (4 each) and
// writes v, m (4 each) and p (2): 20 bytes for 3 floating-point
// operations, far below the card's operations-per-byte balance, so the
// least time is the cell's bytes over the HBM rate. Everything the design
// does is for fewer bytes and full-width accesses:
//  * one pass, in place: no temporaries, each byte read or written once;
//  * `running` is read on the device (the host never learns whether the
//    tick ran); a cell that does not run returns before touching memory;
//  * one launch covers all of a cell's leaves (up to kMaxLeaves; the zoo's
//    largest model has 40): a table of pointers, sizes and dtypes passed
//    by value as the kernel's argument (no copy to the device, no sync),
//    the leaves cut into chunks of kChunk
//    elements numbered across the table, which the blocks walk in a
//    grid-stride loop sized to the card, so each block's leaf cursor only
//    moves forward;
//  * within a chunk each thread takes 4 consecutive elements per step, so
//    a warp's float32 accesses are 16 bytes a thread and its bf16 ones 8,
//    each instruction one contiguous span; all loads of a chunk are
//    issued before the arithmetic; offsets are 64-bit (a leaf may hold
//    more than 2^31 elements);
//  * a leaf whose pointers are not all 16-byte aligned, and the ragged
//    last chunk of every leaf, take a scalar path with the same
//    arithmetic.
//
// Rounding: the _rn intrinsics are never contracted into fused multiply-
// adds, and the library is built with -fmad=false, so the result is
// bit-identical to the plain PyTorch version (kernels/mixed_sgd.py::
// mixed_sgd_update_reference) and to the functional update followed by
// the engine's gate. __float2bfloat16_rn is the conversion PyTorch's own
// CUDA cast uses (cvt.rn.bf16.f32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;        // consecutive elements a thread takes a step
constexpr int kSteps = 4;      // steps a thread takes in one chunk
constexpr int64_t kChunk = static_cast<int64_t>(kThreads) * kVec * kSteps;
constexpr int kMaxLeaves = 64;

// flags of a leaf: a gradient in bf16 comes with a bf16 working copy
constexpr int kGradBf16 = 1;   // else float32
constexpr int kParamBf16 = 2;  // else float32
constexpr int kAligned = 4;    // every pointer 16-byte aligned

struct Leaf {
  const void* g;
  float* v;
  float* m;
  void* p;
  int64_t n;
  int64_t chunk0;  // the leaf's first chunk in the launch's numbering
  int flags;
};

// 64 leaves x 56 bytes + 16: within the 4 KB every toolkit allows for a
// kernel's arguments
struct Table {
  Leaf leaf[kMaxLeaves];
  int n_leaves;
  int64_t n_chunks;
};

__device__ __forceinline__ float bf16_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ uint32_t float_to_bf16(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

__device__ __forceinline__ void sgd(float g, float& v, float& m,
                                    float momentum, float lr) {
  v = __fadd_rn(__fmul_rn(momentum, v), g);
  m = __fsub_rn(m, __fmul_rn(lr, v));
}

// A whole chunk of an aligned leaf: kSteps groups of kVec elements a
// thread, every load issued before the arithmetic.
template <bool kGB, bool kPB>
__device__ __forceinline__ void full_chunk(const Leaf& L, int64_t base,
                                           float momentum, float lr) {
  float g[kSteps][kVec], v[kSteps][kVec], m[kSteps][kVec];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int64_t e = base + (static_cast<int64_t>(s) * kThreads +
                              threadIdx.x) * kVec;
    if (kGB) {
      const uint2 raw =
          __ldg(reinterpret_cast<const uint2*>(
              static_cast<const uint16_t*>(L.g) + e));
      g[s][0] = bf16_to_float(raw.x & 0xffffu);
      g[s][1] = bf16_to_float(raw.x >> 16);
      g[s][2] = bf16_to_float(raw.y & 0xffffu);
      g[s][3] = bf16_to_float(raw.y >> 16);
    } else {
      const float4 raw = __ldg(reinterpret_cast<const float4*>(
          static_cast<const float*>(L.g) + e));
      g[s][0] = raw.x; g[s][1] = raw.y; g[s][2] = raw.z; g[s][3] = raw.w;
    }
    const float4 rv = *reinterpret_cast<const float4*>(L.v + e);
    const float4 rm = *reinterpret_cast<const float4*>(L.m + e);
    v[s][0] = rv.x; v[s][1] = rv.y; v[s][2] = rv.z; v[s][3] = rv.w;
    m[s][0] = rm.x; m[s][1] = rm.y; m[s][2] = rm.z; m[s][3] = rm.w;
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) sgd(g[s][k], v[s][k], m[s][k], momentum, lr);
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int64_t e = base + (static_cast<int64_t>(s) * kThreads +
                              threadIdx.x) * kVec;
    *reinterpret_cast<float4*>(L.v + e) =
        make_float4(v[s][0], v[s][1], v[s][2], v[s][3]);
    const float4 nm = make_float4(m[s][0], m[s][1], m[s][2], m[s][3]);
    *reinterpret_cast<float4*>(L.m + e) = nm;
    if (kPB) {
      uint2 out;
      out.x = float_to_bf16(m[s][0]) | (float_to_bf16(m[s][1]) << 16);
      out.y = float_to_bf16(m[s][2]) | (float_to_bf16(m[s][3]) << 16);
      *reinterpret_cast<uint2*>(static_cast<uint16_t*>(L.p) + e) = out;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(L.p) + e) = nm;
    }
  }
}

// Any chunk, one element at a time: unaligned leaves and ragged ends.
__device__ __forceinline__ void scalar_chunk(const Leaf& L, int64_t base,
                                             float momentum, float lr) {
  const int64_t end = base + kChunk < L.n ? base + kChunk : L.n;
  for (int64_t e = base + threadIdx.x; e < end; e += kThreads) {
    const float g = (L.flags & kGradBf16)
        ? bf16_to_float(static_cast<const uint16_t*>(L.g)[e])
        : static_cast<const float*>(L.g)[e];
    float v = L.v[e], m = L.m[e];
    sgd(g, v, m, momentum, lr);
    L.v[e] = v;
    L.m[e] = m;
    if (L.flags & kParamBf16) {
      static_cast<uint16_t*>(L.p)[e] = static_cast<uint16_t>(float_to_bf16(m));
    } else {
      static_cast<float*>(L.p)[e] = m;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
mixed_sgd_kernel(const __grid_constant__ Table t,
                 const unsigned char* __restrict__ running,
                 const float* __restrict__ lr_ptr, float momentum) {
  if (!*running) return;
  const float lr = *lr_ptr;
  int leaf = 0;
  for (int64_t c = blockIdx.x; c < t.n_chunks; c += gridDim.x) {
    while (leaf + 1 < t.n_leaves && c >= t.leaf[leaf + 1].chunk0) ++leaf;
    const Leaf& L = t.leaf[leaf];
    const int64_t base = (c - L.chunk0) * kChunk;
    if (!(L.flags & kAligned) || base + kChunk > L.n) {
      scalar_chunk(L, base, momentum, lr);
      continue;
    }
    switch (L.flags & (kGradBf16 | kParamBf16)) {
      case kGradBf16 | kParamBf16:
        full_chunk<true, true>(L, base, momentum, lr);
        break;
      case kParamBf16:
        full_chunk<false, true>(L, base, momentum, lr);
        break;
      default:
        full_chunk<false, false>(L, base, momentum, lr);
    }
  }
}

bool aligned16(uintptr_t p) { return (p & 15u) == 0; }

}  // namespace

// One cell's update over `n_leaves` leaves, launched on `stream`: leaf i's
// pointers are ptrs[4i .. 4i+3] = (g, v, m, p), its size numels[i], its
// dtypes flags[i] (bit 0: g is bf16, bit 1: p is bf16; else float32).
// `running` (one bool) and `lr` (one float32) are device pointers.
// Returns the number of launches made (1, or 0 when every leaf is empty),
// or minus the CUDA error; more than kMaxLeaves leaves is refused as
// cudaErrorInvalidValue. The caller checks shapes, dtypes, devices and
// contiguity.
extern "C" int mixed_sgd_launch(int n_leaves, const long long* ptrs,
                                const long long* numels, const int* flags,
                                const unsigned char* running,
                                const float* lr, float momentum,
                                void* stream) {
  if (n_leaves > kMaxLeaves) return -static_cast<int>(cudaErrorInvalidValue);
  Table t;
  t.n_leaves = 0;
  int64_t chunks = 0;
  for (int i = 0; i < n_leaves; ++i) {
    if (numels[i] <= 0) continue;
    Leaf& L = t.leaf[t.n_leaves++];
    L.g = reinterpret_cast<const void*>(ptrs[4 * i]);
    L.v = reinterpret_cast<float*>(ptrs[4 * i + 1]);
    L.m = reinterpret_cast<float*>(ptrs[4 * i + 2]);
    L.p = reinterpret_cast<void*>(ptrs[4 * i + 3]);
    L.n = numels[i];
    L.chunk0 = chunks;
    const bool aligned = aligned16(ptrs[4 * i]) && aligned16(ptrs[4 * i + 1])
        && aligned16(ptrs[4 * i + 2]) && aligned16(ptrs[4 * i + 3]);
    L.flags = (flags[i] & (kGradBf16 | kParamBf16)) |
              (aligned ? kAligned : 0);
    chunks += (L.n + kChunk - 1) / kChunk;
  }
  if (t.n_leaves == 0) return 0;
  t.n_chunks = chunks;
  int device = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mixed_sgd_kernel,
                                                kThreads, 0);
  if (per_sm < 1) per_sm = 1;
  const int64_t want = static_cast<int64_t>(n_sm) * per_sm;
  const unsigned int blocks =
      static_cast<unsigned int>(chunks < want ? chunks : want);
  mixed_sgd_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      t, running, lr, momentum);
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 1 : -static_cast<int>(err);
}
