// Serialized patch attention, backward: dq, dk, dv of softmax(q k^T * scale) v
// within each patch of K slot-gathered rows, one head at a time.
//
// Replaces the TPU kernels `_bwd_kernel_kmajor`, `_bwd_kernel_kmajor_chunked`
// (packed [nP, K, 3C] tile -> packed dqkv), `_bwd_kernel` and
// `_bwd_kernel_chunked` (split [nP*H, K, D] layout) of
// pointcept_tpu/ops/pallas/flash_attention.py. As in the forward, one kernel
// serves every width: a block reads its head's D columns of the packed rows
// by the row stride and writes the head's columns of the packed dqkv.
//
// Maths (FlashAttention-2 style, no [K, K] matrix in device memory). The
// forward saved each row's f32 max m and denominator l, so
//   p  = exp(s * scale - m) / l = ex2(s * scale * log2e - lse2),
//        lse2 = m * log2e + log2(l)       (the forward's unrounded p)
//   D_ = rowsum(dO o O)                    (O: the forward's bf16 output)
//   dV = p^T dO,  dP = dO V^T,  dS = p (dP - D_) * scale,
//   dQ = dS K,    dK = dS^T Q.
// Every product runs on mma.sync.m16n8k16 (bf16 in, f32 accumulate): p and
// p (dP - D_) are rounded to bf16 as operands, the scale is applied to the
// f32 sums of dQ and dK; dq, dk, dv are rounded to bf16 at the end. The TPU
// kernels take the row term as rowsum(dP o p) (whole-K) or dO . o with o
// rebuilt from bf16 p (chunked); D_ from the saved output is the same
// quantity up to bf16 rounding.
//
// What bounds it, on paper: the exps (16 a clock on each SM) and, as
// closely, the tensor cores' five products of 2 * D multiply-adds a score at
// the rate mma.sync reaches. So each score is computed once: one exp, one
// pass (the design this replaces ran two kernels, each with every exp).
//
// Design: a pre-pass kernel (`attn_bwd_prep_kernel`) writes lse2 and D_ once
// per row. The main kernel (`attn_bwd_kernel`) gives each (patch, head) a
// cluster of S blocks that split the key rows; each warp owns T tiles of 16
// keys (T = 4 at D = 16 where K % 64 == 0, else 1), keeps their K and V
// fragments and their dK, dV sums in registers, and walks every query, 64 a
// step. Q, dO and the row terms of the whole patch sit in each block's
// shared memory (cp.async, swizzled, unpadded), where ldmatrix reads them as
// the B operands of k q^T and v dO^T and, transposed, of dV = p^T dO and
// dK = dS^T Q; each fragment read serves the warp's T key tiles. dQ = dS K takes dS^T's fragments
// transposed in registers (movmatrix) and K's from registers, sums the T
// key tiles in registers, and adds the result to an f32 [K, D] tile in
// shared memory: warp w handles query tile (i + w) mod NQ at step i, so no
// two warps touch one tile in a step, and a block barrier ends each step,
// so each tile's partials are added in one fixed order (the first visitor
// writes). At the end the blocks of the cluster add their tiles in rank
// order through distributed shared memory. No atomics anywhere: the result
// is the same bits on every run.
//
// Measured on an H100 (PERF.md): shared memory is the busiest pipe (each
// warp reads Q and dO twice, as rows and transposed, and reads and writes
// its dQ rows, for every 16 queries), so each key tile a warp owns more
// divides that traffic a key: at K = 1024, D = 16 two blocks of 8 warps a
// cluster with four tiles each (136 KB a block, one an SM, 255 registers)
// ran 31-44% faster than four blocks of 16 warps with one tile each, and
// 5-7% faster than two blocks of 16 warps with two. Walking the queries in
// two phases so that two smaller blocks share an SM was no faster (twice
// the staging and the cluster epilogues); so were a ring of 32-query
// tiles, split-phase barriers, per-warp turn flags and persistent clusters.
// Steps of 64 queries beat steps of 32 (half the barriers).
//
// Grid: S blocks (one cluster) per (patch, head), W warps a block; the plan
// (S, W, T) comes from the wrapper (ops/kernels/patch_attention.py, bwd_plan).

#include <cooperative_groups.h>
#include <math.h>

#include "attention_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace attn;

constexpr int kStep = 64;  // queries a warp handles in one step: four m16 tiles

// lse2 and D_ of every row: stats[(p * H + h) * K + r] = (lse2, D_).
template <int D>
__global__ void attn_bwd_prep_kernel(const __nv_bfloat16* __restrict__ out,
                                     const __nv_bfloat16* __restrict__ dout,
                                     const float* __restrict__ mstat,
                                     const float* __restrict__ lstat, float2* __restrict__ stats,
                                     int rows, int K, int C, int H) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const int r = i % K, h = (i / K) % H;
  const size_t p = (size_t)i / K / H;
  const size_t off = (p * K + r) * C + h * D;
  const uint4* o4 = reinterpret_cast<const uint4*>(out + off);
  const uint4* d4 = reinterpret_cast<const uint4*>(dout + off);
  float s = 0.f;
#pragma unroll
  for (int v = 0; v < D / 8; ++v) {
    const uint4 ov = o4[v], dv = d4[v];
    const __nv_bfloat16* oe = reinterpret_cast<const __nv_bfloat16*>(&ov);
    const __nv_bfloat16* de = reinterpret_cast<const __nv_bfloat16*>(&dv);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += __bfloat162float(de[j]) * __bfloat162float(oe[j]);
  }
  stats[i] = make_float2(fmaf(mstat[i], kLog2e, log2f(lstat[i])), s);
}

// Shared memory of a block: Q and dO of the whole patch (bf16, swizzled),
// each query's (lse2, D_) and the f32 dQ tile [kp, D].
template <int D>
size_t smem_bytes(int kp) {
  return (size_t)kp * (2 * D * sizeof(__nv_bfloat16) + sizeof(float2) + D * sizeof(float));
}

// f32 offset of (row, col) in the dQ tile: the 8-column groups of a row are
// permuted by the row so that a warp's float2 accesses (rows g, columns 2t)
// hit 32 distinct banks a phase
template <int D>
__device__ __forceinline__ int dq_off(int row, int col) {
  const int f = D == 16 ? (row >> 1) & 1 : row & 3;
  return row * D + (((col >> 3) ^ f) << 3) + (col & 7);
}

// KT key tiles of 16 a warp
template <int D, int KT, int kMaxWarps>
__global__ void __launch_bounds__(32 * kMaxWarps) attn_bwd_kernel(
    const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ dout,
    const float2* __restrict__ stats, __nv_bfloat16* __restrict__ dqkv, int K, int C, int H,
    int S, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int kp = (K + kStep - 1) / kStep * kStep;  // query rows padded to whole steps
  const int nq = kp / kStep;
  unsigned char* qs = smem;                        // [kp, D] bf16 swizzled
  unsigned char* dos = qs + (size_t)kp * D * 2;    // [kp, D] bf16 swizzled
  float2* st = reinterpret_cast<float2*>(dos + (size_t)kp * D * 2);  // [kp] (lse2, D_)
  float* dq = reinterpret_cast<float*>(st + kp);                      // [kp, D] f32

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int pair = blockIdx.x / S;
  const int h = pair % H;
  const size_t p = pair / H;
  const size_t stride = 3 * (size_t)C;
  const __nv_bfloat16* base = qkv + p * K * stride + h * D;
  const __nv_bfloat16* dbase = dout + p * K * C + h * D;

  stage_rows<D>(qs, base, stride, K);
  stage_rows<D>(dos, dbase, C, K);
  const float2* sg = stats + ((size_t)p * H + h) * K;
  for (int i = threadIdx.x; i < K / 2; i += blockDim.x) cp_async16(st + 2 * i, sg + 2 * i);
  cp_async_commit();
  for (int i = threadIdx.x; i < (kp - K) * D / 8; i += blockDim.x) {
    // padded query rows: zero q and dO, p = ex2(-inf) = 0
    const int r = K + i / (D / 8), c = i % (D / 8);
    *reinterpret_cast<uint4*>(qs + swz<D>(r, c)) = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(dos + swz<D>(r, c)) = make_uint4(0, 0, 0, 0);
  }
  for (int r = K + threadIdx.x; r < kp; r += blockDim.x) st[r] = make_float2(INFINITY, 0.f);
  const int W = blockDim.x / 32;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int j0 = (rank * W + warp) * 16 * KT;    // the warp's 16 * KT keys
  const bool active = j0 < K;
  const int A = min(W, K / (16 * KT) - rank * W);  // warps of this block that own keys

  // each key tile's K and V as A operands of k q^T and v dO^T, K as the B
  // operand of dS K
  uint32_t ka[KT][D / 16][4], va[KT][D / 16][4], kb[KT][D / 8][2];
  float dk[KT][D / 8][4], dv[KT][D / 8][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      dk[kt][j][0] = dk[kt][j][1] = dk[kt][j][2] = dk[kt][j][3] = 0.f;
      dv[kt][j][0] = dv[kt][j][1] = dv[kt][j][2] = dv[kt][j][3] = 0.f;
    }
  if (active) {
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      const int k0 = j0 + 16 * kt;
      frag_a_global<D>(ka[kt], base + C, stride, k0, K, g, t);
      frag_a_global<D>(va[kt], base + 2 * C, stride, k0, K, g, t);
      const __nv_bfloat16* kr = base + C + (size_t)(k0 + 2 * t) * stride + g;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        kb[kt][j][0] = pack2(kr + 8 * j, kr + stride + 8 * j);
        kb[kt][j][1] = pack2(kr + 8 * stride + 8 * j, kr + 9 * stride + 8 * j);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const uint32_t qbase = smem_u32(qs), dobase = smem_u32(dos);
  const float c = scale * kLog2e;
  for (int i = 0; i < nq; ++i) {
    if (active) {
      const int x = (i + warp) % nq;  // the warp's query tile this step
      // the first visitor of a tile writes its dQ rows, the others add
      const bool first = i == 0 || (warp == A - 1 && i + A - 1 < nq);
#pragma unroll
      for (int sub = 0; sub < kStep / 16; ++sub) {
        const int qr = x * kStep + 16 * sub;
        // s^T = k q^T and dP^T = v dO^T: rows = the key tile's keys g, g+8;
        // columns = queries qr + 8n + 2t, +1
        uint32_t qf[2][D / 16][2], df[2][D / 16][2];
        frag_b_rows<D>(qf, qbase, qr, lane);
        frag_b_rows<D>(df, dobase, qr, lane);
        float4 sq[2];
#pragma unroll
        for (int n = 0; n < 2; ++n)
          sq[n] = *reinterpret_cast<const float4*>(st + qr + 8 * n + 2 * t);
        uint32_t pa[KT][4], da[KT][4];  // p^T and dS^T / scale as A fragments (keys x queries)
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          float s[2][4], dp[2][4];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
            dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
            for (int kd = 0; kd < D / 16; ++kd) {
              mma_bf16(s[n], ka[kt][kd], qf[n][kd][0], qf[n][kd][1]);
              mma_bf16(dp[n], va[kt][kd], df[n][kd][0], df[n][kd][1]);
            }
          }
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const float p0 = ex2(fmaf(s[n][0], c, -sq[n].x)), p1 = ex2(fmaf(s[n][1], c, -sq[n].z));
            const float p2 = ex2(fmaf(s[n][2], c, -sq[n].x)), p3 = ex2(fmaf(s[n][3], c, -sq[n].z));
            pa[kt][2 * n] = pack_bf16(p0, p1);
            pa[kt][2 * n + 1] = pack_bf16(p2, p3);
            da[kt][2 * n] = pack_bf16(p0 * (dp[n][0] - sq[n].y), p1 * (dp[n][1] - sq[n].w));
            da[kt][2 * n + 1] = pack_bf16(p2 * (dp[n][2] - sq[n].y), p3 * (dp[n][3] - sq[n].w));
          }
        }
        // dV += p^T dO, dK += dS^T Q: B = dO, Q with the queries as contraction
        uint32_t dt[D / 8][2], qt[D / 8][2];
        frag_b_cols<D>(dt, dobase, qr, lane);
        frag_b_cols<D>(qt, qbase, qr, lane);
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            mma_bf16(dv[kt][j], pa[kt], dt[j][0], dt[j][1]);
            mma_bf16(dk[kt][j], da[kt], qt[j][0], qt[j][1]);
          }
        // dQ[qr.., :] += dS K over the warp's keys: dS's A fragment is dS^T's
        // four 8x8 blocks transposed, (keys, queries) blocks (0,0) (0,1) (1,0) (1,1);
        // the key tiles are summed in registers, in order, before the tile
        uint32_t qa[KT][4];
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          qa[kt][0] = movmatrix_t(da[kt][0]);
          qa[kt][1] = movmatrix_t(da[kt][2]);
          qa[kt][2] = movmatrix_t(da[kt][1]);
          qa[kt][3] = movmatrix_t(da[kt][3]);
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kt = 0; kt < KT; ++kt) mma_bf16(part, qa[kt], kb[kt][j][0], kb[kt][j][1]);
          float2* a0 = reinterpret_cast<float2*>(dq + dq_off<D>(qr + g, 8 * j + 2 * t));
          float2* a8 = reinterpret_cast<float2*>(dq + dq_off<D>(qr + g + 8, 8 * j + 2 * t));
          if (first) {
            *a0 = make_float2(part[0], part[1]);
            *a8 = make_float2(part[2], part[3]);
          } else {
            float2 v0 = *a0, v8 = *a8;
            v0.x += part[0];
            v0.y += part[1];
            v8.x += part[2];
            v8.y += part[3];
            *a0 = v0;
            *a8 = v8;
          }
        }
      }
    }
    __syncthreads();  // the step's dQ rows are in place for the next visitors
  }

  if (active) {
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      __nv_bfloat16* kg = dqkv + (p * K + j0 + 16 * kt + g) * stride + C + h * D;
      __nv_bfloat16* kg8 = kg + 8 * stride;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(kg + j * 8 + 2 * t) =
            pack_bf16(dk[kt][j][0] * scale, dk[kt][j][1] * scale);
        *reinterpret_cast<uint32_t*>(kg8 + j * 8 + 2 * t) =
            pack_bf16(dk[kt][j][2] * scale, dk[kt][j][3] * scale);
        *reinterpret_cast<uint32_t*>(kg + C + j * 8 + 2 * t) =
            pack_bf16(dv[kt][j][0], dv[kt][j][1]);
        *reinterpret_cast<uint32_t*>(kg8 + C + j * 8 + 2 * t) =
            pack_bf16(dv[kt][j][2], dv[kt][j][3]);
      }
    }
  }

  // dQ: the blocks of the cluster add their partial tiles in rank order,
  // each block the rows of its share
  cluster.sync();
  const int share = (K + S - 1) / S;
  const int r_lo = rank * share, r_hi = min(K, r_lo + share);
  for (int i = threadIdx.x; i < (r_hi - r_lo) * (D / 8); i += blockDim.x) {
    const int r = r_lo + i / (D / 8), c8 = 8 * (i % (D / 8));
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int src = 0; src < S; ++src) {
      const float4* part =
          reinterpret_cast<const float4*>(cluster.map_shared_rank(dq, src) + dq_off<D>(r, c8));
      const float4 a = part[0], b = part[1];
      acc[0] += a.x;
      acc[1] += a.y;
      acc[2] += a.z;
      acc[3] += a.w;
      acc[4] += b.x;
      acc[5] += b.y;
      acc[6] += b.z;
      acc[7] += b.w;
    }
    uint4 o;
    o.x = pack_bf16(acc[0] * scale, acc[1] * scale);
    o.y = pack_bf16(acc[2] * scale, acc[3] * scale);
    o.z = pack_bf16(acc[4] * scale, acc[5] * scale);
    o.w = pack_bf16(acc[6] * scale, acc[7] * scale);
    *reinterpret_cast<uint4*>(dqkv + (p * K + r) * stride + h * D + c8) = o;
  }
  cluster.sync();  // no block leaves while another reads its tile
}

template <int D, int KT, int kMaxWarps>
int launch_main(const void* qkv, const void* dout, const float2* st, void* dqkv, int np, int K,
                int C, int H, int S, int W, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>((K + kStep - 1) / kStep * kStep);
  auto* kernel = attn_bwd_kernel<D, KT, kMaxWarps>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)np * H * S, 1, 1);
  cfg.blockDim = dim3(32 * W, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(qkv),
                           static_cast<const __nv_bfloat16*>(dout), st,
                           static_cast<__nv_bfloat16*>(dqkv), K, C, H, S, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* qkv, const void* out, const void* dout, const float* m, const float* l,
           void* stats, void* dqkv, int np, int K, int C, int H, int S, int W, int T, float scale,
           cudaStream_t stream) {
  constexpr int kMaxWarps = D == 16 ? 16 : 8;
  const int keys = 16 * T;  // keys a warp owns
  // every block of a cluster owns keys: a block with none would add a dQ
  // tile it never wrote
  if (S < 1 || S > 8 || W < 1 || W > kMaxWarps || W > (K + kStep - 1) / kStep ||
      (T != 1 && !(D == 16 && T == 4 && W <= 8)) || K % keys != 0 || S * W * keys < K ||
      (S - 1) * W * keys >= K)
    return (int)cudaErrorInvalidValue;
  const int rows = np * H * K;
  auto* st = static_cast<float2*>(stats);
  attn_bwd_prep_kernel<D><<<(rows + 255) / 256, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(dout), m, l, st,
      rows, K, C, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (D == 16) {
    // four key tiles take twice the registers of one: at most 8 warps
    if (T == 4) return launch_main<D, 4, 8>(qkv, dout, st, dqkv, np, K, C, H, S, W, scale, stream);
  }
  return launch_main<D, 1, kMaxWarps>(qkv, dout, st, dqkv, np, K, C, H, S, W, scale, stream);
}

}  // namespace

// qkv [np, K, 3C] bf16 (q | k | v, heads of D columns each), out and dout
// [np, K, C] bf16 (the forward's output and its cotangent), m and l
// [np, H, K] f32 (the forward's row max and denominator), stats [np, H, K, 2]
// f32 scratch -> dqkv [np, K, 3C] bf16. The wrapper's plan: S blocks a
// cluster of W warps that own T key tiles of 16 each (T = 1, or 4 at
// D = 16 with W <= 8), (S - 1) * W * 16T < K <= S * W * 16T, K % 16T == 0,
// W at most the K / 64 query tiles. Returns the cudaError_t of the launches.
extern "C" int patch_attention_bwd(const void* qkv, const void* out, const void* dout,
                                   const void* m, const void* l, void* stats, void* dqkv, int np,
                                   int K, int C, int H, int D, int S, int W, int T, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 16 != 0) return (int)cudaErrorInvalidValue;
  const auto* mf = static_cast<const float*>(m);
  const auto* lf = static_cast<const float*>(l);
  switch (D) {
    case 16:
      return launch<16>(qkv, out, dout, mf, lf, stats, dqkv, np, K, C, H, S, W, T, scale, s);
    case 32:
      return launch<32>(qkv, out, dout, mf, lf, stats, dqkv, np, K, C, H, S, W, T, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
