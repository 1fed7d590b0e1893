// Block fill: z-sorted point rows -> raster dense tiles.
//
// Replaces the TPU kernel `_fill_kernel` of pointcept_tpu/ops/pallas/block_fill.py.
// There the placement is a one-hot matmul in VMEM, because TPU scatters
// serialize. Here it is plain data movement: slots are unique, so no atomics
// are needed.
//
// out [(m+1)*b3, C]: rows [t*b3, (t+1)*b3) are block t's tile, with sorted
// point i at row rc[i] (rc = rank*b3 + raster_local; rc = -1 is dropped) and
// zeros elsewhere; tile m is all zero (halo expansion reads it for missing
// neighbours). The TPU kernel's rounding of the row count up to a fill group
// is not reproduced.
//
// Design: one block per tile. Block t's members are contiguous in the sorted
// order at [starts[t], starts[t] + count) with count <= b3, so the block reads
// the b3 codes of that window, inverts them into a slot -> row table in shared
// memory, and writes its whole tile once: zeros and point rows together, in
// 16-byte vectors when C % 8 == 0 (the stem's C = 6 takes 2-byte stores).
// Every output byte is written exactly once, so no separate zero fill runs.
//
// What bounds it: bytes. The dense output ((m+1)*b3*C*2 bytes, mostly zeros)
// dominates the point rows and codes it reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool kVec16>
__global__ void __launch_bounds__(kThreads) block_fill_kernel(
    const __nv_bfloat16* __restrict__ feat, const int32_t* __restrict__ rc,
    const int32_t* __restrict__ starts, __nv_bfloat16* __restrict__ out, int n, int m, int b3,
    int C) {
  extern __shared__ int32_t src[];  // [b3] sorted row feeding each slot, -1 = empty
  const int t = blockIdx.x;
  for (int i = threadIdx.x; i < b3; i += blockDim.x) src[i] = -1;
  __syncthreads();
  if (t < m) {
    const int s0 = starts[t];
    for (int i = threadIdx.x; i < b3; i += blockDim.x) {
      const int row = s0 + i;
      if (row < n) {
        const int code = rc[row];
        if (code >= 0 && code / b3 == t) src[code - t * b3] = row;
      }
    }
  }
  __syncthreads();
  __nv_bfloat16* tile = out + (size_t)t * b3 * C;
  if (kVec16) {
    const int per_row = C / 8;
    uint4* dst = reinterpret_cast<uint4*>(tile);
    for (int v = threadIdx.x; v < b3 * per_row; v += blockDim.x) {
      const int s = v / per_row;
      const int row = src[s];
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row >= 0) val = reinterpret_cast<const uint4*>(feat + (size_t)row * C)[v - s * per_row];
      dst[v] = val;
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int e = threadIdx.x; e < b3 * C; e += blockDim.x) {
      const int s = e / C;
      const int row = src[s];
      tile[e] = row >= 0 ? feat[(size_t)row * C + (e - s * C)] : zero;
    }
  }
}

}  // namespace

// feat [n, C] bf16, rc [n] int32, starts [m] int32 -> out [(m+1)*b3, C] bf16.
// Returns the cudaError_t of the launch.
extern "C" int block_fill(const void* feat, const void* rc, const void* starts, void* out, int n,
                          int m, int b3, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)b3 * sizeof(int32_t);
  const auto* f = static_cast<const __nv_bfloat16*>(feat);
  const auto* r = static_cast<const int32_t*>(rc);
  const auto* st = static_cast<const int32_t*>(starts);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (C % 8 == 0)
    block_fill_kernel<true><<<m + 1, kThreads, smem, s>>>(f, r, st, o, n, m, b3, C);
  else
    block_fill_kernel<false><<<m + 1, kThreads, smem, s>>>(f, r, st, o, n, m, b3, C);
  return (int)cudaGetLastError();
}
