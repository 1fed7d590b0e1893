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
// What bounds it: each score costs one exp on the SFU (16 a clock on each
// SM) against 4 * D multiply-adds on the tensor cores (D = 16 or 32), so the
// exps bound the work, not the tensor cores or the nP*K*4C*2 bytes it moves.
// The design keeps the other pipes off the exps' path:
//  - one FFMA and one ex2.approx a score: exp(s * scale - m) is
//    ex2(s * scale * log2e - m * log2e), with m * log2e taken once a row;
//    pass 1 takes the max of the raw scores (scale > 0 commutes with max);
//  - K and V of the (patch, head) are staged once per block, unpadded and
//    swizzled (attention_common.cuh), by cp.async in two groups, so that V
//    arrives while pass 1 runs; fragments come by ldmatrix, V's by
//    ldmatrix.trans from its row-major copy (no transposed staging);
//  - each warp owns 32 query rows (two m16 tiles sharing every K and V
//    fragment; one tile where the grid is small, see `launch`) and runs
//    q k^T and p v on mma.sync.m16n8k16; the score accumulators are
//    repacked in place as the A operand of p v.
// Head dim 24 (the Utonia configs' 18, zero-padded by the wrapper) stages
// 48-byte rows and pads the contraction to 32 in registers only
// (attention_common.cuh): 96 KB of K and V at K = 1024, two blocks an SM.
// A block holds 256 query rows; at D = 16 its 64 KB of K and V for K = 1024
// and at most 80 registers a thread leave room for three blocks an SM, so
// one block's staging overlaps the others' exps (two blocks, at 122
// registers, ran 5-7% slower, and a grid of 320 blocks took two waves).
// wgmma is not used: its 64-row tiles would not raise the exp-bound rate,
// and at D = 16 one product is a single k16 step.
//
// For the backward (csrc/patch_attention_bwd.cu) it also writes, when asked,
// each row's f32 max m and denominator l ([nP, H, K] each).
//
// With a score bias (PT-v3m1's relative position encoding, RPE) the block
// also stages its K keys' grid coordinates (int4 rows, 16 bytes a key) and
// its head's column of the f32 table [3 * (2b + 1), H], scaled by log2(e),
// in shared memory. Each score then gets
//   t[clip(dx) + b] + t[(2b+1) + clip(dy) + b] + t[2(2b+1) + clip(dz) + b],
// (dx, dy, dz) the query's coordinate minus the key's, clipped to [-b, b],
// added after the scale: the softmax runs over s * scale + bias, in log2
// units (u = s * scale * log2e + bias * log2e), and m is the row max of the
// biased scores. The query rows' coordinates sit in registers. The bias is
// recomputed in both passes (three table reads a score) and never written
// to device memory: at K = 128 a [nP, H, K, K] f32 bias of two 262,144-row
// scenes would be 268 MB a block.
//
// Grid: one block per (patch, head, tile of 256 or 128 query rows); 8 warps.

#include <math.h>

#include "attention_common.cuh"

// PATCH_ATTENTION_RPE = 1 (set by patch_attention_rpe.cu, which includes this
// file) builds the score-biased instances in place of the unbiased ones: a
// library of their own, which nvcc compiles beside this one.
#ifndef PATCH_ATTENTION_RPE
#define PATCH_ATTENTION_RPE 0
#endif

namespace {

using namespace attn;

constexpr int kWarps = 8;

// the staged RPE of a block: the keys' coordinates and the head's table
// rows, each axis's pointer at its bin 0 (so a clipped difference indexes it)
struct Rpe {
  const int4* kc;
  const float* tx;
  const float* ty;
  const float* tz;
  int b;
  __device__ __forceinline__ float operator()(const int3& q, const int4& k) const {
    return tx[min(max(q.x - k.x, -b), b)] + ty[min(max(q.y - k.y, -b), b)] +
           tz[min(max(q.z - k.z, -b), b)];
  }
};

template <int D, int MT>
__device__ __forceinline__ void scores(float (&s)[MT][2][4], const uint32_t (&qa)[MT][kSteps<D>][4],
                                       const uint32_t (&kb)[2][kSteps<D>][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < kSteps<D>; ++kd) mma_bf16(s[mt][n], qa[mt][kd], kb[n][kd][0], kb[n][kd][1]);
    }
}

// MT m16 tiles of query rows a warp: a block holds 8 * 16 * MT rows. BIAS:
// the RPE score bias from `table` [3 * (2 * bnd + 1), H] f32 and `coords`
// [nP, K, 3] int32 (the slots' grid coordinates).
template <int D, int MT, bool BIAS>
__global__ void __launch_bounds__(32 * kWarps, D == 16 ? (BIAS ? 2 : 3) : 2) patch_attention_fwd_kernel(
    const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int K, int C, int H, float scale,
    const float* __restrict__ table, const int* __restrict__ coords, int bnd) {
  constexpr int kWarpRows = 16 * MT;
  constexpr int kRows = kWarpRows * kWarps;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ks = smem;                    // [K, D] swizzled
  unsigned char* vs = smem + (size_t)K * D * 2;  // [K, D] swizzled

  const int tiles = (K + kRows - 1) / kRows;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % H;
  const size_t p = blockIdx.x / tiles / H;
  const size_t stride = 3 * (size_t)C;
  const __nv_bfloat16* base = qkv + p * K * stride + h * D;

  stage_rows<D>(ks, base + C, stride, K);
  cp_async_commit();
  stage_rows<D>(vs, base + 2 * C, stride, K);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row group and column pair
  const int r0 = tile * kRows + warp * kWarpRows;
  const bool active = r0 < K;  // K % 16 == 0: a later m16 tile may lie past K

  // RPE: the keys' coordinates and the head's table (x log2e) in shared
  // memory, made visible by the barrier before pass 1; the query rows'
  // coordinates (rows g, g + 8 of each m16 tile, clamped as q is) in registers
  Rpe rpe{};
  int3 qc[MT][2];
  if constexpr (BIAS) {
    const int nb = 2 * bnd + 1;
    int4* kc = reinterpret_cast<int4*>(smem + 4 * (size_t)K * D);
    float* tab = reinterpret_cast<float*>(kc + K);
    const int* crd = coords + p * K * 3;
    for (int i = threadIdx.x; i < K; i += blockDim.x)
      kc[i] = make_int4(crd[3 * i], crd[3 * i + 1], crd[3 * i + 2], 0);
    for (int i = threadIdx.x; i < 3 * nb; i += blockDim.x) tab[i] = table[(size_t)i * H + h] * kLog2e;
    rpe = Rpe{kc, tab + bnd, tab + nb + bnd, tab + 2 * nb + bnd, bnd};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int* q = crd + 3 * min(r0 + 16 * mt + g + 8 * i, K - 1);
        qc[mt][i] = make_int3(q[0], q[1], q[2]);
      }
  }

  // A fragments of q (rows past K repeat row K - 1 and are not stored)
  uint32_t qa[MT][kSteps<D>][4];
  if (active) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) frag_a_global<D>(qa[mt], base, stride, r0 + 16 * mt, K, g, t);
  }
  const uint32_t kbase = smem_u32(ks), vbase = smem_u32(vs);

  // pass 1: row max of the raw scores (rows g, g+8 of each m16 tile)
  float mx[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) mx[mt][0] = mx[mt][1] = -INFINITY;
  cp_async_wait<1>();
  __syncthreads();
  const float c = scale * kLog2e;
  if (active) {
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t kb[2][kSteps<D>][2];
      frag_b_rows<D>(kb, kbase, k0, lane);
      float s[MT][2][4];
      scores<D, MT>(s, qa, kb);
      if constexpr (BIAS) {
        // the biased scores in log2 units; keys k0 + 8n + 2t, +1
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int4 k_0 = rpe.kc[k0 + 8 * n + 2 * t], k_1 = rpe.kc[k0 + 8 * n + 2 * t + 1];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mx[mt][0] = fmaxf(mx[mt][0], fmaxf(fmaf(s[mt][n][0], c, rpe(qc[mt][0], k_0)),
                                               fmaf(s[mt][n][1], c, rpe(qc[mt][0], k_1))));
            mx[mt][1] = fmaxf(mx[mt][1], fmaxf(fmaf(s[mt][n][2], c, rpe(qc[mt][1], k_0)),
                                               fmaf(s[mt][n][3], c, rpe(qc[mt][1], k_1))));
          }
        }
      } else {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mx[mt][0] = fmaxf(mx[mt][0], fmaxf(s[mt][n][0], s[mt][n][1]));
            mx[mt][1] = fmaxf(mx[mt][1], fmaxf(s[mt][n][2], s[mt][n][3]));
          }
      }
    }
  }
  float m[MT][2], mb[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v = mx[mt][i];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if constexpr (BIAS) {
        mb[mt][i] = v;  // the row max of the biased scores, log2 units
        m[mt][i] = v * (1.f / kLog2e);
      } else {
        m[mt][i] = v * scale;     // the row max of s * scale
        mb[mt][i] = m[mt][i] * kLog2e;
      }
    }

  // pass 2: p = exp(s * scale - m), the sum of the unrounded p, o += bf16(p) v
  float acc[MT][D / 8][4];
  float l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!active) return;
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t kb[2][kSteps<D>][2], vb[D / 8][2];
    frag_b_rows<D>(kb, kbase, k0, lane);
    frag_b_cols<D>(vb, vbase, k0, lane);
    float s[MT][2][4];
    scores<D, MT>(s, qa, kb);
    int4 kc2[2][2];  // RPE: the coordinates of keys k0 + 8n + 2t, +1
    if constexpr (BIAS) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        kc2[n][0] = rpe.kc[k0 + 8 * n + 2 * t];
        kc2[n][1] = rpe.kc[k0 + 8 * n + 2 * t + 1];
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t pa[4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float o0 = -mb[mt][0], o1 = -mb[mt][0], o2 = -mb[mt][1], o3 = -mb[mt][1];
        if constexpr (BIAS) {
          o0 += rpe(qc[mt][0], kc2[n][0]);
          o1 += rpe(qc[mt][0], kc2[n][1]);
          o2 += rpe(qc[mt][1], kc2[n][0]);
          o3 += rpe(qc[mt][1], kc2[n][1]);
        }
        const float e0 = ex2(fmaf(s[mt][n][0], c, o0));
        const float e1 = ex2(fmaf(s[mt][n][1], c, o1));
        const float e2 = ex2(fmaf(s[mt][n][2], c, o2));
        const float e3 = ex2(fmaf(s[mt][n][3], c, o3));
        l[mt][0] += e0 + e1;
        l[mt][1] += e2 + e3;
        // the S fragment of keys [k0 + 8n, +8) is the A fragment's columns 8n..
        pa[2 * n] = pack_bf16(e0, e1);
        pa[2 * n + 1] = pack_bf16(e2, e3);
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) mma_bf16(acc[mt][j], pa, vb[j][0], vb[j][1]);
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = r0 + mt * 16;
    if (r >= K) break;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[mt][i] += __shfl_xor_sync(0xffffffffu, l[mt][i], 1);
      l[mt][i] += __shfl_xor_sync(0xffffffffu, l[mt][i], 2);
    }
    const float inv0 = 1.f / l[mt][0], inv1 = 1.f / l[mt][1];
    __nv_bfloat16* og = out + (p * K + r + g) * C + h * D;
    __nv_bfloat16* og8 = og + 8 * (size_t)C;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(og + j * 8 + 2 * t) =
          pack_bf16(acc[mt][j][0] * inv0, acc[mt][j][1] * inv0);
      *reinterpret_cast<uint32_t*>(og8 + j * 8 + 2 * t) =
          pack_bf16(acc[mt][j][2] * inv1, acc[mt][j][3] * inv1);
    }
    if (m_out != nullptr && t == 0) {
      const size_t srow = (p * H + h) * K + r;
      m_out[srow + g] = m[mt][0];
      m_out[srow + g + 8] = m[mt][1];
      l_out[srow + g] = l[mt][0];
      l_out[srow + g + 8] = l[mt][1];
    }
  }
}

// Shared memory of a block: K and V of its (patch, head), bf16; with BIAS
// also the keys' coordinates (int4 a key) and the head's table column.
template <int D, bool BIAS>
size_t fwd_smem(int K, int bnd) {
  const size_t kv = 2 * (size_t)K * D * sizeof(__nv_bfloat16);
  return BIAS ? kv + (size_t)K * sizeof(int4) + 3 * (2 * (size_t)bnd + 1) * sizeof(float) : kv;
}

template <int D, int MT, bool BIAS>
int launch_rows(const void* qkv, void* out, float* m, float* l, int np, int K, int C, int H,
                float scale, const float* table, const int* coords, int bnd, cudaStream_t stream) {
  const size_t smem = fwd_smem<D, BIAS>(K, bnd);
  cudaError_t err = cudaFuncSetAttribute(patch_attention_fwd_kernel<D, MT, BIAS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = 16 * MT * kWarps;
  const unsigned blocks = (unsigned)np * H * ((K + rows - 1) / rows);
  patch_attention_fwd_kernel<D, MT, BIAS><<<blocks, 32 * kWarps, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), m, l, K, C, H,
      scale, table, coords, bnd);
  return (int)cudaGetLastError();
}

// Blocks of 256 query rows stage K and V half as often as blocks of 128 and
// run 10% faster a row; the smaller blocks spread the rows more evenly over
// the SMs. Takes the smaller only where the busiest SM (blocks dealt out in
// turn) would hold at most 8/9 of the rows it holds with the larger: on an
// H100 at K = 1024, D = 16 that is 80 and 112 (patch, head) pairs of the
// main paths, 4-9% faster there, and the larger wins or ties at the other
// ten (PERF.md).
template <int D, bool BIAS>
int launch(const void* qkv, void* out, float* m, float* l, int np, int K, int C, int H,
           float scale, const float* table, const int* coords, int bnd, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long pairs = (long)np * H;
  const long busiest256 = (pairs * ((K + 255) / 256) + sms - 1) / sms * 256;
  const long busiest128 = (pairs * ((K + 127) / 128) + sms - 1) / sms * 128;
  const int mt = 9 * busiest128 <= 8 * busiest256 ? 1 : 2;
  return mt == 1 ? launch_rows<D, 1, BIAS>(qkv, out, m, l, np, K, C, H, scale, table, coords, bnd, stream)
                 : launch_rows<D, 2, BIAS>(qkv, out, m, l, np, K, C, H, scale, table, coords, bnd, stream);
}

template <int D>
int launch_any(const void* qkv, void* out, float* m, float* l, int np, int K, int C, int H,
               float scale, const float* table, const int* coords, int bnd, cudaStream_t stream) {
  return launch<D, PATCH_ATTENTION_RPE != 0>(qkv, out, m, l, np, K, C, H, scale, table, coords, bnd, stream);
}

}  // namespace

// qkv [np, K, 3C] bf16 row-major (q | k | v, heads of D columns each) ->
// out [np, K, C] bf16, and when m and l are not null the row statistics
// m, l [np, H, K] f32; D 16, 24 or 32, K % 16 == 0. The RPE library
// (PATCH_ATTENTION_RPE) takes the bias: table [3 * (2 * bnd + 1), H] f32,
// coords [np, K, 3] int32; the unbiased one null table and coords. Returns
// the cudaError_t of the launch.
extern "C" int patch_attention_fwd(const void* qkv, void* out, void* m, void* l, int np, int K,
                                   int C, int H, int D, float scale, const void* table,
                                   const void* coords, int bnd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 16 != 0 || (table != nullptr) != (PATCH_ATTENTION_RPE != 0) ||
      (table != nullptr && (coords == nullptr || bnd < 0)))
    return (int)cudaErrorInvalidValue;
  auto* mf = static_cast<float*>(m);
  auto* lf = static_cast<float*>(l);
  const auto* tf = static_cast<const float*>(table);
  const auto* ci = static_cast<const int*>(coords);
  switch (D) {
    case 16:
      return launch_any<16>(qkv, out, mf, lf, np, K, C, H, scale, tf, ci, bnd, s);
    case 24:
      return launch_any<24>(qkv, out, mf, lf, np, K, C, H, scale, tf, ci, bnd, s);
    case 32:
      return launch_any<32>(qkv, out, mf, lf, np, K, C, H, scale, tf, ci, bnd, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
