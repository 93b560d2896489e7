// Fused elastic SGD update for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/elastic_update.py::
// elastic_sgd_update (body _update_kernel). Per replica row r of the flat
// replica-blocked (R, P) float32 layout:
//
//     inv = w_sum[r] > 0 ? 1 / max(w_sum[r], 1e-6) : 0
//     v'  = momentum * v + g * inv
//     p'  = p - lr[r] * v'
//     (p, v) = running[r] ? (p', v') : (p, v)
//
// p and v are updated IN PLACE (the reference writes new arrays and relies
// on buffer donation; at full width a second copy of p and v would not fit
// on an 80 GB card).
//
// Bound: memory. Each element reads p, v, g and writes p, v: 20 bytes for
// 5 floating-point operations, far below the card's operations-per-byte
// balance, so the least time is R*P*20 bytes over the HBM rate. The design
// is a plain grid-stride loop: replicas on gridDim.y, P-blocks on
// gridDim.x, 64-bit offsets throughout (R*P exceeds 2^31 at full width),
// the ragged tail masked by the loop bound instead of padding the buffers.
// A row that is not running returns before touching memory: keeping (p, v)
// is then free.
//
// Rounding: the products and sums use the _rn intrinsics, which are never
// contracted into fused multiply-adds, and the library is built with
// -fmad=false, so the result is bit-identical to the plain PyTorch version
// (kernels/ref.py::elastic_update_reference).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
elastic_update_kernel(float* __restrict__ p, float* __restrict__ v,
                      const float* __restrict__ g,
                      const float* __restrict__ w_sum,
                      const unsigned char* __restrict__ running,
                      const float* __restrict__ lr, int64_t n_cols,
                      float momentum) {
  const int64_t row = blockIdx.y;
  if (!running[row]) return;
  const float w = w_sum[row];
  const float inv = (w > 0.0f) ? __fdiv_rn(1.0f, fmaxf(w, 1e-6f)) : 0.0f;
  const float rate = lr[row];
  const int64_t base = row * n_cols;
  float* __restrict__ pr = p + base;
  float* __restrict__ vr = v + base;
  const float* __restrict__ gr = g + base;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n_cols; i += stride) {
    const float vn = __fadd_rn(__fmul_rn(momentum, vr[i]),
                               __fmul_rn(gr[i], inv));
    pr[i] = __fsub_rn(pr[i], __fmul_rn(rate, vn));
    vr[i] = vn;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success). The
// caller checks shapes, dtypes, devices and contiguity.
extern "C" int elastic_update_launch(float* p, float* v, const float* g,
                                     const float* w_sum,
                                     const unsigned char* running,
                                     const float* lr, long long n_rows,
                                     long long n_cols, float momentum,
                                     void* stream) {
  if (n_rows <= 0 || n_cols <= 0) return 0;
  if (n_rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, n_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  // enough blocks per row to fill every SM several times over, no more
  // than the row needs; the loop strides over the rest
  const long long per_row = (n_cols + kThreads - 1) / kThreads;
  long long want = (static_cast<long long>(n_sm) * 8 + n_rows - 1) / n_rows;
  if (want < 1) want = 1;
  const unsigned int blocks_x =
      static_cast<unsigned int>(per_row < want ? per_row : want);
  dim3 grid(blocks_x, static_cast<unsigned int>(n_rows));
  elastic_update_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      p, v, g, w_sum, running, lr, static_cast<int64_t>(n_cols), momentum);
  return static_cast<int>(cudaGetLastError());
}
