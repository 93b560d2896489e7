// MoE dispatch tables for Hopper (sm_90a): one launch builds the (E, C)
// token, combine-weight and validity tables of a capacity-routed MoE
// layer (`models/moe._dispatch_tables`).
//
// Replaces no Pallas kernel: the reference builds the tables in jnp
// (src/repro/models/moe.py::_dispatch_tables: a cumsum over the (T*k, E)
// one-hot of the flat expert ids, then three scatters), which XLA fuses.
// Eager PyTorch ran the same steps as ≈ 18 launches, one of them an int64
// scan along the one-hot's outer dimension that gives each of the E
// columns one thread walking all T*k rows in turn (≈ 14 ms at T*k = 49,104,
// E = 64 on an H100).
//
// What it computes. Assignment j = t*k + i (token t's i-th expert e_j) has
// rank r_j = #{j' < j : e_j' = e_j}, its place among its expert's
// assignments in token order. Where r_j < C it fills slot (e_j, r_j) with
// token t, weight topv[j] and valid 1; an assignment past its expert's
// capacity is dropped. Every slot left empty gets token 0, weight 0.0 and
// valid 0. The same integers, and the weights' bits copied, as the plain
// version (kernels/moe_dispatch.py::dispatch_tables_reference).
//
// Bound: latency, not bytes or operations. The inputs are T*k ids (393 KB
// in int64 at the shapes above) and the outputs 9 bytes a slot (0.55 MB):
// well under a microsecond of HBM. The ranks are a prefix count, serial in
// token order, so the design keeps the serial part short:
//  * one block per expert (grid = E); a block walks the flat ids in tiles
//    of kTile = kThreads * kItems, every id of a tile loaded before any is
//    used (all blocks read the same ids, so after the first they come from
//    L2);
//  * in a tile, each warp's hits on its expert come from __ballot_sync and
//    a lane's rank within its warp from __popc of the hits below it; one
//    warp turns the tile's (item, warp) counts into exclusive offsets with
//    shuffles; a running count carries the ranks across tiles;
//  * a block stops reading once its count reaches C: every later
//    assignment of its expert is dropped;
//  * it then writes its own empty slots [count, C), so no fill launches
//    precede it.
// It also writes each slot's assignment index j (n = T*k for an empty
// slot), from which the backward scatters the combine weights' gradient
// back to topv.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                  // ids a thread takes a tile
constexpr int kTile = kThreads * kItems;
constexpr int kCounts = kItems * kWarps;   // a tile's (item, warp) counts
constexpr int kPerLane = kCounts / 32;     // of them, one scanning lane's
static_assert(kCounts % 32 == 0, "the scanning warp's lanes share evenly");

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
moe_dispatch_kernel(const Idx* __restrict__ flat_e,
                    const float* __restrict__ topv, int64_t n, int k,
                    int capacity, int* __restrict__ tok,
                    float* __restrict__ cmb, unsigned char* __restrict__ val,
                    int64_t* __restrict__ asg) {
  // offset[it * kWarps + w]: the hits of the tile before (item it, warp w),
  // which is the order of the assignments j = base + it * kThreads + tid
  __shared__ int offset[kCounts];
  __shared__ int tile_hits;
  const int expert = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int64_t row = static_cast<int64_t>(expert) * capacity;
  int count = 0;  // the expert's assignments before this tile
  for (int64_t base = 0; base < n && count < capacity; base += kTile) {
    bool hit[kItems];
    unsigned mask[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int64_t j = base + it * kThreads + threadIdx.x;
      hit[it] = j < n && flat_e[j] == static_cast<Idx>(expert);
    }
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      mask[it] = __ballot_sync(0xffffffffu, hit[it]);
      if (lane == 0) offset[it * kWarps + warp] = __popc(mask[it]);
    }
    __syncthreads();
    if (warp == 0) {
      int own[kPerLane];
      int sum = 0;
#pragma unroll
      for (int p = 0; p < kPerLane; ++p) {
        own[p] = offset[lane * kPerLane + p];
        sum += own[p];
      }
      int inclusive = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, inclusive, d);
        if (lane >= d) inclusive += up;
      }
      int run = inclusive - sum;
#pragma unroll
      for (int p = 0; p < kPerLane; ++p) {
        offset[lane * kPerLane + p] = run;
        run += own[p];
      }
      if (lane == 31) tile_hits = inclusive;
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      if (!hit[it]) continue;
      const int rank = count + offset[it * kWarps + warp] +
                       __popc(mask[it] & below);
      if (rank >= capacity) continue;
      const int64_t j = base + it * kThreads + threadIdx.x;
      tok[row + rank] = static_cast<int>(j / k);
      cmb[row + rank] = topv[j];
      val[row + rank] = 1;
      asg[row + rank] = j;
    }
    count += tile_hits;
    __syncthreads();  // the next tile rewrites offset and tile_hits
  }
  for (int s = (count < capacity ? count : capacity) + threadIdx.x;
       s < capacity; s += kThreads) {
    tok[row + s] = 0;
    cmb[row + s] = 0.0f;
    val[row + s] = 0;
    asg[row + s] = n;
  }
}

}  // namespace

// The tables of n = T*k assignments over n_experts experts at `capacity`
// slots each, launched on `stream`: flat_e the (T, k) expert ids, int64
// where idx_is_64 else int32; topv their float32 weights; tok (int32),
// cmb (float32) and val (bool, one byte) the (n_experts, capacity) tables,
// and asg (int64, the same shape) each slot's assignment index. Returns
// the number of launches made (1, or 0 when the tables are empty) or minus
// the CUDA error. The caller checks devices, dtypes, shapes, contiguity
// and that n < 2^31.
extern "C" int moe_dispatch_launch(const void* flat_e, int idx_is_64,
                                   const float* topv, long long n, int k,
                                   int n_experts, int capacity, int* tok,
                                   float* cmb, unsigned char* val,
                                   long long* asg, void* stream) {
  if (n_experts <= 0 || capacity <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* slots = reinterpret_cast<int64_t*>(asg);
  if (idx_is_64) {
    moe_dispatch_kernel<int64_t><<<n_experts, kThreads, 0, s>>>(
        static_cast<const int64_t*>(flat_e), topv, n, k, capacity, tok, cmb,
        val, slots);
  } else {
    moe_dispatch_kernel<int32_t><<<n_experts, kThreads, 0, s>>>(
        static_cast<const int32_t*>(flat_e), topv, n, k, capacity, tok, cmb,
        val, slots);
  }
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 1 : -static_cast<int>(err);
}
