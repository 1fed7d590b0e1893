// Serialized patch attention, backward: dq, dk, dv of softmax(q k^T * scale) v
// within each patch of K slot-gathered rows, one head at a time.
//
// Replaces the TPU kernels `_bwd_kernel_kmajor`, `_bwd_kernel_kmajor_chunked`
// (packed [nP, K, 3C] tile -> packed dqkv), `_bwd_kernel` and
// `_bwd_kernel_chunked` (split [nP*H, K, D] layout) of
// pointcept_tpu/ops/pallas/flash_attention.py. As in the forward, one kernel
// family serves every width: a block reads its head's D columns of the packed
// rows by the row stride and writes the head's columns of the packed dqkv.
//
// Maths (FlashAttention-2 style, no [K, K] matrix in device memory). The
// forward saved each row's f32 max m and denominator l, so
//   p  = exp(s * scale - m) / l           (the forward's unrounded p, exactly)
//   D_ = rowsum(dO o O)                    (O: the forward's bf16 output)
//   dV = p^T dO,  dP = dO V^T,  dS = p (dP - D_) * scale,
//   dQ = dS K,    dK = dS^T Q.
// Every product runs on mma.sync.m16n8k16 (bf16 in, f32 accumulate): p and dS
// are rounded to bf16 as A operands; dq, dk, dv are rounded to bf16 at the end.
// The TPU kernels take the row term as rowsum(dP o p) (whole-K) or dO . o with
// o rebuilt from bf16 p (chunked); D_ from the saved output is the same
// quantity up to bf16 rounding.
//
// Design: two kernels, no atomics, so the result is deterministic.
//  - dq: a block owns (patch, head, 128 query rows); K and V of the head sit in
//    shared memory row-major (the B operand of q k^T and dO v^T) and K again
//    transposed (the B operand of dS K). Each warp keeps its 16 rows of q and
//    dO as A fragments in registers and walks the keys 16 at a time; the score
//    and dP accumulators are turned into dS in registers and repacked in place
//    as the A operand of dS K, as the forward repacks p.
//  - dkv: a block owns (patch, head, 128 key rows); Q and dO of the head sit in
//    shared memory row-major and transposed, with each query's m, 1/l and D_.
//    Each warp computes the transposed tiles s^T = k q^T and dP^T = v dO^T for
//    its 16 keys, turns them into p^T and dS^T, and accumulates
//    dV += p^T dO and dK += dS^T Q.
// Rows in shared memory are padded by 8 elements (bank-conflict-free fragment
// loads), as in the forward.
//
// What bounds it: the exps. Each score needs one exp on the SFU in each of
// the two kernels, against 2*D multiply-adds of each of four products on the
// tensor cores; at D = 16 the SFU is the slower unit by far.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 16 * kWarps;  // rows (queries or keys) per block
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

// A fragments (16 rows x D) of a row-major matrix: rows g and g+8 of `rows`
// (row stride `stride` elements), columns 2t.. and 2t+8.. of each 16.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const __nv_bfloat16* rows,
                                       size_t stride, int g, int t) {
  const __nv_bfloat16* r0 = rows + (size_t)g * stride;
  const __nv_bfloat16* r8 = r0 + 8 * stride;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    a[kd][0] = ld32(r0 + kd * 16 + 2 * t);
    a[kd][1] = ld32(r8 + kd * 16 + 2 * t);
    a[kd][2] = ld32(r0 + kd * 16 + 2 * t + 8);
    a[kd][3] = ld32(r8 + kd * 16 + 2 * t + 8);
  }
}

// [16 x 16] product tile: the warp's A rows against rows [c0, c0+16) of the
// row-major shared-memory matrix `b` ([rows, D+pad]), contracting over D.
template <int D>
__device__ __forceinline__ void tile16(float (&s)[2][4], const uint32_t (&a)[D / 16][4],
                                       const __nv_bfloat16* b, int c0, int g, int t) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const __nv_bfloat16* brow = b + (c0 + n * 8 + g) * (D + kPad);
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd)
      mma_bf16(s[n], a[kd], ld32(brow + kd * 16 + 2 * t), ld32(brow + kd * 16 + 2 * t + 8));
  }
}

// sum_d a[d] * b[d] in f32, d in order
template <int D>
__device__ __forceinline__ float row_dot(const __nv_bfloat16* a, const __nv_bfloat16* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) s += __bfloat162float(a[d]) * __bfloat162float(b[d]);
  return s;
}

// Copies the D columns of K rows (row stride `stride`) into `rm` [K, D+pad]
// row-major and `tr` [D, K+pad] transposed.
template <int D>
__device__ __forceinline__ void stage_rows(const __nv_bfloat16* src, size_t stride, int K,
                                           __nv_bfloat16* rm, __nv_bfloat16* tr) {
  constexpr int kVec = D / 8;  // 16-byte vectors per head row
  const int kp = K + kPad;
  for (int i = threadIdx.x; i < K * kVec; i += blockDim.x) {
    const int r = i / kVec, v = i % kVec;
    const uint4 raw = reinterpret_cast<const uint4*>(src + (size_t)r * stride)[v];
    reinterpret_cast<uint4*>(rm + r * (D + kPad))[v] = raw;
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) tr[(v * 8 + j) * kp + r] = e[j];
  }
}

template <int D>
__global__ void __launch_bounds__(32 * kWarps) attn_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ out,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ mstat,
    const float* __restrict__ lstat, __nv_bfloat16* __restrict__ dqkv, int K, int C, int H,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [K, D+pad]
  __nv_bfloat16* vs = ks + (size_t)K * (D + kPad);              // [K, D+pad]
  __nv_bfloat16* kt = vs + (size_t)K * (D + kPad);              // [D, K+pad]
  const int kp = K + kPad;

  const int tiles = (K + kRows - 1) / kRows;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % H;
  const size_t p = blockIdx.x / tiles / H;
  const size_t stride = 3 * (size_t)C;
  const __nv_bfloat16* base = qkv + p * K * stride + h * D;

  stage_rows<D>(base + C, stride, K, ks, kt);
  {
    constexpr int kVec = D / 8;
    for (int i = threadIdx.x; i < K * kVec; i += blockDim.x) {
      const int r = i / kVec, v = i % kVec;
      reinterpret_cast<uint4*>(vs + r * (D + kPad))[v] =
          reinterpret_cast<const uint4*>(base + 2 * C + (size_t)r * stride)[v];
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = tile * kRows + warp * 16;
  if (r0 >= K) return;  // K % 16 == 0: a warp's rows are all in or all out

  uint32_t qa[D / 16][4], da[D / 16][4];
  load_a<D>(qa, base + (size_t)r0 * stride, stride, g, t);
  const __nv_bfloat16* drows = dout + (p * K + r0) * C + h * D;
  const __nv_bfloat16* orows = out + (p * K + r0) * C + h * D;
  load_a<D>(da, drows, C, g, t);
  const size_t srow = (p * H + h) * K + r0;
  const float m0 = mstat[srow + g], m1 = mstat[srow + g + 8];
  const float il0 = 1.f / lstat[srow + g], il1 = 1.f / lstat[srow + g + 8];
  const float d0 = row_dot<D>(drows + (size_t)g * C, orows + (size_t)g * C);
  const float d1 = row_dot<D>(drows + (size_t)(g + 8) * C, orows + (size_t)(g + 8) * C);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 16) {
    float s[2][4], dp[2][4];
    tile16<D>(s, qa, ks, k0, g, t);
    tile16<D>(dp, da, vs, k0, g, t);
    uint32_t sa[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float p0 = __expf(s[n][0] * scale - m0) * il0, p1 = __expf(s[n][1] * scale - m0) * il0;
      const float p2 = __expf(s[n][2] * scale - m1) * il1, p3 = __expf(s[n][3] * scale - m1) * il1;
      // dS of keys [k0 + 8n, +8) is the A fragment's columns 8n.. of dS K
      sa[2 * n] = pack_bf16(p0 * (dp[n][0] - d0) * scale, p1 * (dp[n][1] - d0) * scale);
      sa[2 * n + 1] = pack_bf16(p2 * (dp[n][2] - d1) * scale, p3 * (dp[n][3] - d1) * scale);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const __nv_bfloat16* krow = kt + (j * 8 + g) * kp + k0 + 2 * t;
      mma_bf16(acc[j], sa, ld32(krow), ld32(krow + 8));
    }
  }
  __nv_bfloat16* og = dqkv + (p * K + r0 + g) * stride + h * D;
  __nv_bfloat16* og8 = og + 8 * stride;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(og + j * 8 + 2 * t) = pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(og8 + j * 8 + 2 * t) = pack_bf16(acc[j][2], acc[j][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(32 * kWarps) attn_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ out,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ mstat,
    const float* __restrict__ lstat, __nv_bfloat16* __restrict__ dqkv, int K, int C, int H,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [K, D+pad]
  __nv_bfloat16* dos = qs + (size_t)K * (D + kPad);             // [K, D+pad]
  __nv_bfloat16* qt = dos + (size_t)K * (D + kPad);             // [D, K+pad]
  __nv_bfloat16* dot = qt + (size_t)D * (K + kPad);             // [D, K+pad]
  float* mrow = reinterpret_cast<float*>(dot + (size_t)D * (K + kPad));  // [K]
  float* ilrow = mrow + K;                                               // [K]
  float* delta = ilrow + K;                                              // [K]
  const int kp = K + kPad;

  const int tiles = (K + kRows - 1) / kRows;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % H;
  const size_t p = blockIdx.x / tiles / H;
  const size_t stride = 3 * (size_t)C;
  const __nv_bfloat16* base = qkv + p * K * stride + h * D;
  const __nv_bfloat16* drows = dout + p * K * C + h * D;
  const __nv_bfloat16* orows = out + p * K * C + h * D;
  const size_t srow = (p * H + h) * K;

  stage_rows<D>(base, stride, K, qs, qt);
  stage_rows<D>(drows, C, K, dos, dot);
  for (int r = threadIdx.x; r < K; r += blockDim.x) {
    mrow[r] = mstat[srow + r];
    ilrow[r] = 1.f / lstat[srow + r];
    delta[r] = row_dot<D>(drows + (size_t)r * C, orows + (size_t)r * C);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int j0 = tile * kRows + warp * 16;  // the warp's 16 keys
  if (j0 >= K) return;

  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a<D>(ka, base + (size_t)j0 * stride + C, stride, g, t);
  load_a<D>(va, base + (size_t)j0 * stride + 2 * C, stride, g, t);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }
  for (int i0 = 0; i0 < K; i0 += 16) {
    float s[2][4], dp[2][4];  // s^T and dP^T: rows = keys g, g+8; columns = queries
    tile16<D>(s, ka, qs, i0, g, t);
    tile16<D>(dp, va, dos, i0, g, t);
    uint32_t pa[4], sa[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int c = i0 + n * 8 + 2 * t;  // queries c and c+1
      const float ma = mrow[c], mb = mrow[c + 1], la = ilrow[c], lb = ilrow[c + 1];
      const float da = delta[c], db = delta[c + 1];
      const float p0 = __expf(s[n][0] * scale - ma) * la, p1 = __expf(s[n][1] * scale - mb) * lb;
      const float p2 = __expf(s[n][2] * scale - ma) * la, p3 = __expf(s[n][3] * scale - mb) * lb;
      pa[2 * n] = pack_bf16(p0, p1);
      pa[2 * n + 1] = pack_bf16(p2, p3);
      sa[2 * n] = pack_bf16(p0 * (dp[n][0] - da) * scale, p1 * (dp[n][1] - db) * scale);
      sa[2 * n + 1] = pack_bf16(p2 * (dp[n][2] - da) * scale, p3 * (dp[n][3] - db) * scale);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const __nv_bfloat16* drow = dot + (j * 8 + g) * kp + i0 + 2 * t;
      mma_bf16(dv[j], pa, ld32(drow), ld32(drow + 8));
      const __nv_bfloat16* qrow = qt + (j * 8 + g) * kp + i0 + 2 * t;
      mma_bf16(dk[j], sa, ld32(qrow), ld32(qrow + 8));
    }
  }
  __nv_bfloat16* kg = dqkv + (p * K + j0 + g) * stride + C + h * D;
  __nv_bfloat16* kg8 = kg + 8 * stride;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(kg + j * 8 + 2 * t) = pack_bf16(dk[j][0], dk[j][1]);
    *reinterpret_cast<uint32_t*>(kg8 + j * 8 + 2 * t) = pack_bf16(dk[j][2], dk[j][3]);
    *reinterpret_cast<uint32_t*>(kg + C + j * 8 + 2 * t) = pack_bf16(dv[j][0], dv[j][1]);
    *reinterpret_cast<uint32_t*>(kg8 + C + j * 8 + 2 * t) = pack_bf16(dv[j][2], dv[j][3]);
  }
}

template <int D>
size_t dq_smem(int K) {
  return (2 * (size_t)K * (D + kPad) + (size_t)D * (K + kPad)) * sizeof(__nv_bfloat16);
}

template <int D>
size_t dkv_smem(int K) {
  return (2 * (size_t)K * (D + kPad) + 2 * (size_t)D * (K + kPad)) * sizeof(__nv_bfloat16) +
         3 * (size_t)K * sizeof(float);
}

template <int D>
int launch(const void* qkv, const void* out, const void* dout, const float* m, const float* l,
           void* dqkv, int np, int K, int C, int H, float scale, cudaStream_t stream) {
  const size_t s1 = dq_smem<D>(K), s2 = dkv_smem<D>(K);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s2);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (K + kRows - 1) / kRows;
  const unsigned blocks = (unsigned)np * H * tiles;
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* o = static_cast<const __nv_bfloat16*>(out);
  const auto* d = static_cast<const __nv_bfloat16*>(dout);
  auto* g = static_cast<__nv_bfloat16*>(dqkv);
  attn_bwd_dq_kernel<D><<<blocks, 32 * kWarps, s1, stream>>>(q, o, d, m, l, g, K, C, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv_kernel<D><<<blocks, 32 * kWarps, s2, stream>>>(q, o, d, m, l, g, K, C, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv [np, K, 3C] bf16 (q | k | v, heads of D columns each), out and dout
// [np, K, C] bf16 (the forward's output and its cotangent), m and l
// [np, H, K] f32 (the forward's row max and denominator) -> dqkv [np, K, 3C]
// bf16. K % 16 == 0. Returns the cudaError_t of the launches.
extern "C" int patch_attention_bwd(const void* qkv, const void* out, const void* dout,
                                   const void* m, const void* l, void* dqkv, int np, int K, int C,
                                   int H, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 16 != 0) return (int)cudaErrorInvalidValue;
  const auto* mf = static_cast<const float*>(m);
  const auto* lf = static_cast<const float*>(l);
  switch (D) {
    case 16:
      return launch<16>(qkv, out, dout, mf, lf, dqkv, np, K, C, H, scale, s);
    case 32:
      return launch<32>(qkv, out, dout, mf, lf, dqkv, np, K, C, H, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
