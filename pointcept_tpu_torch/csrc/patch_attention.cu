// Serialized patch attention, forward: softmax(q k^T * scale) v within each
// patch of K slot-gathered rows, one head at a time.
//
// Replaces the TPU kernels `_fwd_kernel_kmajor` (packed [nP, K, 3C] tile, all
// heads in one grid cell) and `_fwd_kernel` (split [nP*H, K, D] layout) of
// pointcept_tpu/ops/pallas/flash_attention.py. One kernel serves every width:
// a block reads its head's D columns of the packed rows by the row stride 3C,
// so the split layout (a TPU VMEM workaround for C > 128) and the head-packing
// trick (a workaround for the MXU's contraction depth) are not needed.
//
// Maths, as on the TPU: s = (q . k) * scale in f32 from bf16 operands; a
// two-pass softmax over the whole patch (pass 1 the row max, pass 2 the
// exponentials); p is rounded to bf16 before p . v (f32 accumulation), and
// the row is divided by the f32 sum of the unrounded p at the end. The two
// passes keep that rounding exact, where an online softmax would round p
// against a running max.
//
// What bounds it: with D = 16 each score costs 2*D multiply-adds on the
// tensor cores but one exp on the SFU (16 per clock per SM), so the exps
// bound the work, not the tensor cores or the nP*K*4C*2 bytes it moves.
// Design: each warp owns 16 query rows and runs q k^T and p v as
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) over 16-key chunks; the
// scores stay in registers and the S accumulator fragments are repacked in
// place as the A operand of p v (no shared-memory round trip). K (row-major)
// and V (transposed) of the (patch, head) sit in shared memory with rows
// padded by 8 elements, which makes the fragment loads bank-conflict free.
//
// For the backward (csrc/patch_attention_bwd.cu) it also writes, when asked,
// each row's f32 max m and denominator l ([nP, H, K] each): the backward then
// recomputes the forward's unrounded p = exp(s * scale - m) / l exactly.
//
// Grid: one block per (patch, head, tile of 128 query rows); 8 warps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 16 * kWarps;  // query rows per block
constexpr int kPad = 8;             // elements of padding per shared-memory row

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S[16 rows x 16 keys] of this warp for keys [k0, k0+16): two n8 tiles.
template <int D>
__device__ __forceinline__ void scores(float (&s)[2][4], const uint32_t (&qa)[D / 16][4],
                                       const __nv_bfloat16* ks, int k0, int g, int t) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const __nv_bfloat16* krow = ks + (k0 + n * 8 + g) * (D + kPad);
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      mma_bf16(s[n], qa[kd], ld32(krow + kd * 16 + 2 * t), ld32(krow + kd * 16 + 2 * t + 8));
  }
}

template <int D>
__global__ void __launch_bounds__(32 * kWarps) patch_attention_fwd_kernel(
    const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int K, int C, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [K, D+pad]
  __nv_bfloat16* vt = ks + (size_t)K * (D + kPad);              // [D, K+pad]
  const int kp = K + kPad;

  const int tiles = (K + kRows - 1) / kRows;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % H;
  const size_t p = blockIdx.x / tiles / H;
  const size_t stride = 3 * (size_t)C;
  const __nv_bfloat16* base = qkv + p * K * stride + h * D;

  constexpr int kVec = D / 8;  // 16-byte vectors per head row
  for (int i = threadIdx.x; i < K * kVec; i += blockDim.x) {
    const int r = i / kVec, v = i % kVec;
    const __nv_bfloat16* row = base + r * stride;
    reinterpret_cast<uint4*>(ks + r * (D + kPad))[v] = reinterpret_cast<const uint4*>(row + C)[v];
    uint4 raw = reinterpret_cast<const uint4*>(row + 2 * C)[v];
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) vt[(v * 8 + j) * kp + r] = e[j];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group and column pair
  const int r0 = tile * kRows + warp * 16;
  if (r0 >= K) return;  // K % 16 == 0: a warp's rows are all in or all out

  // A fragments of q: rows r0+g and r0+g+8, columns 2t.. and 2t+8..
  uint32_t qa[D / 16][4];
  const __nv_bfloat16* qg = base + (size_t)(r0 + g) * stride;
  const __nv_bfloat16* qg8 = qg + 8 * stride;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    qa[kd][0] = ld32(qg + kd * 16 + 2 * t);
    qa[kd][1] = ld32(qg8 + kd * 16 + 2 * t);
    qa[kd][2] = ld32(qg + kd * 16 + 2 * t + 8);
    qa[kd][3] = ld32(qg8 + kd * 16 + 2 * t + 8);
  }

  // pass 1: row max of s (rows g and g+8 of the warp's 16)
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int k0 = 0; k0 < K; k0 += 16) {
    float s[2][4];
    scores<D>(s, qa, ks, k0, g, t);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      m0 = fmaxf(m0, fmaxf(s[n][0], s[n][1]) * scale);
      m1 = fmaxf(m1, fmaxf(s[n][2], s[n][3]) * scale);
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }

  // pass 2: p = exp(s - m), denominator of the unrounded p, o += bf16(p) v
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  for (int k0 = 0; k0 < K; k0 += 16) {
    float s[2][4];
    scores<D>(s, qa, ks, k0, g, t);
    uint32_t pa[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float e0 = __expf(s[n][0] * scale - m0), e1 = __expf(s[n][1] * scale - m0);
      const float e2 = __expf(s[n][2] * scale - m1), e3 = __expf(s[n][3] * scale - m1);
      l0 += e0 + e1;
      l1 += e2 + e3;
      // the S fragment of keys [k0 + 8n, +8) is the A fragment's columns 8n..
      pa[2 * n] = pack_bf16(e0, e1);
      pa[2 * n + 1] = pack_bf16(e2, e3);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const __nv_bfloat16* vrow = vt + (j * 8 + g) * kp + k0 + 2 * t;
      mma_bf16(acc[j], pa, ld32(vrow), ld32(vrow + 8));
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  __nv_bfloat16* og = out + (p * K + r0 + g) * C + h * D;
  __nv_bfloat16* og8 = og + 8 * (size_t)C;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(og + j * 8 + 2 * t) = pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
    *reinterpret_cast<uint32_t*>(og8 + j * 8 + 2 * t) = pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
  }
  if (m_out != nullptr && t == 0) {
    const size_t srow = (p * H + h) * K + r0;
    m_out[srow + g] = m0;
    m_out[srow + g + 8] = m1;
    l_out[srow + g] = l0;
    l_out[srow + g + 8] = l1;
  }
}

template <int D>
int launch(const void* qkv, void* out, float* m, float* l, int np, int K, int C, int H,
           float scale, cudaStream_t stream) {
  const size_t smem = ((size_t)K * (D + kPad) + (size_t)D * (K + kPad)) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(patch_attention_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (K + kRows - 1) / kRows;
  const unsigned blocks = (unsigned)np * H * tiles;
  patch_attention_fwd_kernel<D><<<blocks, 32 * kWarps, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), m, l, K, C, H,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv [np, K, 3C] bf16 row-major (q | k | v, heads of D columns each) ->
// out [np, K, C] bf16, and when m and l are not null the row statistics
// m, l [np, H, K] f32; K % 16 == 0. Returns the cudaError_t of the launch.
extern "C" int patch_attention_fwd(const void* qkv, void* out, void* m, void* l, int np, int K,
                                   int C, int H, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 16 != 0) return (int)cudaErrorInvalidValue;
  auto* mf = static_cast<float*>(m);
  auto* lf = static_cast<float*>(l);
  switch (D) {
    case 16:
      return launch<16>(qkv, out, mf, lf, np, K, C, H, scale, s);
    case 32:
      return launch<32>(qkv, out, mf, lf, np, K, C, H, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
