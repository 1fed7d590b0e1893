// Take-back: dense conv output rows -> per-point rows, out[i] = dense[slot[i]].
//
// Replaces the TPU kernel `_copy_kernel` of pointcept_tpu/ops/pallas/layout_pin.py
// (`pin_rowmajor`), an identity copy whose only job was to keep XLA's layout
// assignment from flipping the preceding row gather (`jnp.take` at
// pointcept_tpu/ops/block_conv.py `_take_back`) to a row-minor layout.
// PyTorch assigns no layouts, so the copy is fused with the gather it pinned:
// this kernel writes the contiguous row-major [N, C] result straight from the
// dense rows. The TPU-only `zfold` widening of narrow rows is not needed.
//
// It is also the fill's VJP (`_block_fill_bwd`, pointcept_tpu/ops/block_conv.py):
// there the cotangent of the dense rows is gathered at each point's slot, and
// slots at or past `bound` (the zero tile: padding and overflow points) give
// zero rows, because the zero tile's cotangent holds the halo reads of missing
// neighbours and is not the point's own.
//
// What bounds it: bytes (N*C*2 read at scattered rows, N*C*2 written, N*4 of
// slots). Each thread moves one 16-byte vector when C % 8 == 0, neighbouring
// threads on neighbouring addresses of one row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) take_back_vec16_kernel(
    const uint4* __restrict__ dense, const int32_t* __restrict__ slot, uint4* __restrict__ out,
    long long total, int per_row, int bound) {
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x; v < total;
       v += (long long)gridDim.x * blockDim.x) {
    const long long i = v / per_row;
    const int s = slot[i];
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    out[v] = s < bound ? dense[(long long)s * per_row + (v - i * per_row)] : zero;
  }
}

__global__ void __launch_bounds__(kThreads) take_back_kernel(
    const __nv_bfloat16* __restrict__ dense, const int32_t* __restrict__ slot,
    __nv_bfloat16* __restrict__ out, long long total, int C, int bound) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long i = e / C;
    const int s = slot[i];
    out[e] = s < bound ? dense[(long long)s * C + (e - i * C)] : __float2bfloat16(0.f);
  }
}

}  // namespace

// dense [R, C] bf16, slot [n] int32 (every slot < R) -> out [n, C] bf16, with
// zero rows where slot >= bound (bound <= R). Returns the cudaError_t of the launch.
extern "C" int take_back_rows(const void* dense, const void* slot, void* out, int n, int C,
                              int bound, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sl = static_cast<const int32_t*>(slot);
  if (n == 0) return (int)cudaGetLastError();
  if (C % 8 == 0) {
    const int per_row = C / 8;
    const long long total = (long long)n * per_row;
    const long long want = (total + kThreads - 1) / kThreads;
    const unsigned blocks = (unsigned)(want < 65535LL * 32 ? want : 65535LL * 32);
    take_back_vec16_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const uint4*>(dense), sl,
                                                       static_cast<uint4*>(out), total, per_row,
                                                       bound);
  } else {
    const long long total = (long long)n * C;
    const long long want = (total + kThreads - 1) / kThreads;
    const unsigned blocks = (unsigned)(want < 65535LL * 32 ? want : 65535LL * 32);
    take_back_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(dense), sl,
                                                 static_cast<__nv_bfloat16*>(out), total, C, bound);
  }
  return (int)cudaGetLastError();
}
