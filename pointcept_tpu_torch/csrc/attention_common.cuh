// Device helpers shared by the patch-attention kernels (patch_attention.cu,
// patch_attention_bwd.cu): mma.sync, ldmatrix, movmatrix, cp.async and the
// swizzled shared-memory layout of a head's rows.
//
// A head row of D bf16 values is D / 8 chunks of 16 bytes, stored unpadded.
// Chunk c of row r sits at chunk position c ^ swz(r), where swz spreads the
// eight rows that one ldmatrix reads over all 32 banks (D = 16: two chunks a
// row, swz = (r / 4) % 2; D = 32: four chunks, swz = (r / 2) % 4).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8, row l % 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the transpose of an 8x8 b16 matrix held as one mma fragment register a lane
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 of different rows packed as one fragment register
__device__ __forceinline__ uint32_t pack2(const __nv_bfloat16* lo, const __nv_bfloat16* hi) {
  __nv_bfloat162 v;
  v.x = *lo;
  v.y = *hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// byte offset of chunk c (8 bf16) of row r in a swizzled [rows, D] tile
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int kChunks = D / 8;
  return (uint32_t)(r * D * 2 + 16 * (c ^ ((r / (8 / kChunks)) % kChunks)));
}

// Stages the D columns of `rows` rows (row stride `stride` elements) into the
// swizzled tile `dst` with cp.async, all threads of the block taking part.
template <int D>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const __nv_bfloat16* src,
                                           size_t stride, int rows) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = i % kChunks;
    cp_async16(dst + swz<D>(r, c), src + (size_t)r * stride + c * 8);
  }
}

// B fragments of a [16 rows x D] slice (rows r0..r0+15) of a swizzled tile
// whose rows are the n index and whose columns are the contraction:
// b[n8][kd][2] for S = A * tile^T (q k^T: the tile is K).
template <int D>
__device__ __forceinline__ void frag_b_rows(uint32_t (&b)[2][D / 16][2], uint32_t base, int r0,
                                            int lane) {
  const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    uint32_t r[4];
    ldsm_x4(r, base + swz<D>(r0 + (mi >> 1) * 8 + rr, 2 * kd + (mi & 1)));
    b[0][kd][0] = r[0];
    b[0][kd][1] = r[1];
    b[1][kd][0] = r[2];
    b[1][kd][1] = r[3];
  }
}

// B fragments of the same slice as the contraction rows: b[n8 of D][2] for
// O = P * tile (p v: the tile is V), via ldmatrix.trans.
template <int D>
__device__ __forceinline__ void frag_b_cols(uint32_t (&b)[D / 8][2], uint32_t base, int r0,
                                            int lane) {
  const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int c = 0; c < D / 8; c += 2) {
    uint32_t r[4];
    ldsm_x4_t(r, base + swz<D>(r0 + (mi & 1) * 8 + rr, c + (mi >> 1)));
    b[c][0] = r[0];
    b[c][1] = r[1];
    b[c + 1][0] = r[2];
    b[c + 1][1] = r[3];
  }
}

// A fragments (16 rows x D) of row-major global rows r0.. (row stride
// `stride`); rows at or past `rows` read row rows - 1.
template <int D>
__device__ __forceinline__ void frag_a_global(uint32_t (&a)[D / 16][4], const __nv_bfloat16* src,
                                              size_t stride, int r0, int rows, int g, int t) {
  const __nv_bfloat16* p0 = src + (size_t)min(r0 + g, rows - 1) * stride;
  const __nv_bfloat16* p8 = src + (size_t)min(r0 + g + 8, rows - 1) * stride;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    a[kd][0] = ld32(p0 + kd * 16 + 2 * t);
    a[kd][1] = ld32(p8 + kd * 16 + 2 * t);
    a[kd][2] = ld32(p0 + kd * 16 + 2 * t + 8);
    a[kd][3] = ld32(p8 + kd * 16 + 2 * t + 8);
  }
}

}  // namespace attn
