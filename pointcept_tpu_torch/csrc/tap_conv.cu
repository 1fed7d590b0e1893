// Fused block conv: a dense k^3 convolution over z-order blocks whose halo is
// read straight from the neighbour blocks, and its weight gradient.
//
// Replaces the TPU kernels of pointcept_tpu/ops/pallas/tap_conv.py:
// `_conv_kernel_banded` and `_conv_kernel_sliced` (via `tap_conv`) and
// `_dw_kernel_banded` and `_dw_kernel_sliced` (via `tap_conv_dw`), together
// with the halo assembly that feeds them (`_halo_expand_flat`,
// pointcept_tpu/ops/block_conv.py). The TPU kernels read a halo tensor that
// XLA materialises in HBM and pick a banded, sliced or tap-chunked regime to
// fit VMEM; none of that is carried over.
//
// tap_conv_fwd: dense [(m+1)*b^3, Cin] bf16 (the fill's raster tiles, tile m
// all zero), nbr [m+1, 27] int32 (neighbour tiles in OFFS27 order, m =
// missing), W [k^3, Cin, Cout] ->
//     out[r*b^3 + v, co] = sum_tap sum_ci tile(r, v + tap - h)[ci] * W[tap, ci, co]
// in f32, stored bf16; the source voxel lies in tile r or one of its 26
// neighbours. Only occupied tiles (r < m and nbr[r, 13] == r) are computed;
// every other tile, the zero tile included, is written as zeros. The same
// kernel is the input gradient: run on the cotangent's tiles with the
// index-reversed, channel-transposed weight.
//
// Design (implicit GEMM, mma.sync m16n8k16 bf16 -> f32): a thread block owns
// one b=8 tile (or several b=4 tiles) and NT output channels; each warp owns
// 64 output rows. Per chunk of CK input channels the block stages the tiles'
// halos (H^3 rows, H = b + k - 1) in shared memory from the neighbour tiles,
// then runs the k^3 shifted products: A fragments come by ldmatrix from the
// halo rows at the tap's offset, B fragments from the tap's weight slice,
// double-buffered in shared memory. No halo tensor reaches HBM. Odd widths
// are padded inside (channels past Cin read zero, weight padded by the
// wrapper, columns past Cout not stored).
//
// tap_conv_dw: dW[tap, ci, co] = sum_r sum_v tile(r, v + tap - h)[ci] * g[r*b^3 + v, co]
// over the occupied tiles, f32 [k^3, Cin, Cout]. A first kernel lists the
// occupied tiles in order; the list is cut into P contiguous ranges (P fixed
// by the shapes); each block sums one range for 32 taps (all 27 of a k3
// kernel; four per warp, which share the cotangent's fragments), CK input
// and NT output channels into its own f32 partial, contracting over the
// voxels with ldmatrix.trans fragments; a last kernel adds the P partials
// in order. No atomics: the weight gradient is bit-reproducible.
//
// What bounds them: operations. 2 * occupied tiles * b^3 * k^3 * Cin * Cout
// flops on the tensor cores against reading each occupied tile's halo once per
// NT output channels; the simple synchronous staging here leaves the tensor
// cores idle while a chunk loads (wgmma and TMA are later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPadE = 8;                  // bf16 elements of padding per shared-memory row
constexpr size_t kMaxSmem = 232448;       // dynamic shared memory a block may use on Hopper
constexpr int kDwWarps = 8;               // warps of a weight-gradient block
constexpr int kDwTapsPerWarp = 4;         // taps each warp accumulates
constexpr int kDwTaps = kDwWarps * kDwTapsPerWarp;  // taps of a block: a k3 kernel's 27 at once

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Halo coordinate x in [0, H) along one axis -> region (0, 1, 2 for the
// neighbour at -1, 0, +1) and the coordinate inside that tile.
__device__ __forceinline__ void halo_src(int x, int b, int h, int& reg, int& s) {
  if (x < h) {
    reg = 0;
    s = b - h + x;
  } else if (x < h + b) {
    reg = 1;
    s = x - h;
  } else {
    reg = 2;
    s = x - h - b;
  }
}

// 8 channels [c, c+8) of one dense row, zero past C.
__device__ __forceinline__ uint4 load8(const bf16* __restrict__ src, size_t row, int C, int c,
                                       bool vec) {
  if (vec && c + 8 <= C) return *reinterpret_cast<const uint4*>(src + row * C + c);
  uint4 v;
  bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = (c + j < C) ? src[row * C + c + j] : __float2bfloat16(0.f);
  return v;
}

// Stages the halos of `ntiles` tiles (halo rows of RS elements, channels
// [c0, c0+CK) of dense) into hal [ntiles][H^3][RS]. nb: [ntiles][27]
// neighbour ranks; skip[s] != 0 leaves tile s unstaged.
template <int CK>
__device__ void stage_halo(bf16* hal, const int* nb, const int* skip, int ntiles,
                           const bf16* __restrict__ dense, int b, int h, int H, int Cin, int c0) {
  constexpr int G = CK / 8;
  constexpr int RS = CK + kPadE;
  const int H3 = H * H * H, b3 = b * b * b;
  const bool vec = (Cin % 8) == 0;
  const int total = ntiles * H3 * G;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int cg = i % G;
    const int vox = (i / G) % H3;
    const int s = i / (G * H3);
    if (skip != nullptr && skip[s]) continue;
    const int z = vox % H, y = (vox / H) % H, x = vox / (H * H);
    int rx, sx, ry, sy, rz, sz;
    halo_src(x, b, h, rx, sx);
    halo_src(y, b, h, ry, sy);
    halo_src(z, b, h, rz, sz);
    const int rank = nb[s * 27 + (rx * 3 + ry) * 3 + rz];
    const size_t row = (size_t)rank * b3 + (sx * b + sy) * b + sz;
    *reinterpret_cast<uint4*>(hal + ((size_t)s * H3 + vox) * RS + cg * 8) =
        load8(dense, row, Cin, c0 + cg * 8, vec);
  }
}

// ---------------------------------------------------------------- forward

template <int NT, int CK>
__global__ void __launch_bounds__(256) tap_conv_fwd_kernel(
    const bf16* __restrict__ dense, const int32_t* __restrict__ nbr,
    const bf16* __restrict__ wt,  // [k^3, Cout_p, Cin_p]: weight transposed and padded
    bf16* __restrict__ out, int m, int b, int k, int Cin, int Cin_p, int Cout, int Cout_p,
    int tpb) {
  constexpr int RS = CK + kPadE;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b3 = b * b * b, h = (k - 1) / 2, H = b + 2 * h, H3 = H * H * H, K3 = k * k * k;
  bf16* hal = reinterpret_cast<bf16*>(smem);  // [tpb][H3][RS]
  bf16* ws = hal + (size_t)tpb * H3 * RS;     // [2][NT][RS]
  int* nb = reinterpret_cast<int*>(ws + 2 * NT * RS);  // [tpb][27]
  int* idle = nb + tpb * 27;                           // [tpb]: 1 = not computed

  const int R = m + 1;
  const int r0 = blockIdx.x * tpb;
  const int n0 = blockIdx.y * NT;
  for (int i = threadIdx.x; i < tpb * 27; i += blockDim.x) {
    const int r = r0 + i / 27;
    nb[i] = r < R ? nbr[(size_t)r * 27 + i % 27] : m;
  }
  for (int s = threadIdx.x; s < tpb; s += blockDim.x) {
    const int r = r0 + s;
    idle[s] = !(r < m && nbr[(size_t)r * 27 + 13] == r);
  }
  __syncthreads();
  int busy = 0;
  for (int s = 0; s < tpb; ++s) busy |= !idle[s];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow = warp * 64;    // the warp's first row within the block's tiles
  const int tile_s = wrow / b3;  // its tile within the block
  const int lrow = wrow % b3;    // its first row within that tile
  const bool active = !idle[tile_s];

  float acc[4][NT / 8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  if (busy) {
    // ldmatrix row of this lane in each 16-row m tile: matrices 0/1 rows
    // 0-7 / 8-15 at channels 0-7, matrices 2/3 the same rows at channels 8-15
    int hbase[4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int v = lrow + mt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
      const int ox = v / (b * b), oy = (v / b) % b, oz = v % b;
      hbase[mt] = tile_s * H3 + (ox * H + oy) * H + oz;
    }
    const int a_coff = (lane >> 4) * 8;
    const int b_row = (lane >> 4) * 8 + (lane & 7);  // n row of this lane's B matrix
    const int b_coff = ((lane >> 3) & 1) * 8;
    constexpr int WV = NT * CK / 8;  // 16-byte vectors of one tap's weight slice

    for (int c0 = 0; c0 < Cin_p; c0 += CK) {
      __syncthreads();
      stage_halo<CK>(hal, nb, idle, tpb, dense, b, h, H, Cin, c0);
      for (int i = threadIdx.x; i < WV; i += blockDim.x) {
        const int n = i / (CK / 8), q = i % (CK / 8);
        *reinterpret_cast<uint4*>(ws + n * RS + q * 8) = *reinterpret_cast<const uint4*>(
            wt + ((size_t)n0 + n) * Cin_p + c0 + q * 8);
      }
      __syncthreads();
      for (int tap = 0; tap < K3; ++tap) {
        if (tap + 1 < K3) {
          bf16* nxt = ws + ((tap + 1) & 1) * NT * RS;
          for (int i = threadIdx.x; i < WV; i += blockDim.x) {
            const int n = i / (CK / 8), q = i % (CK / 8);
            *reinterpret_cast<uint4*>(nxt + n * RS + q * 8) = *reinterpret_cast<const uint4*>(
                wt + ((size_t)(tap + 1) * Cout_p + n0 + n) * Cin_p + c0 + q * 8);
          }
        }
        if (active) {
          const int dx = tap / (k * k), dy = (tap / k) % k, dz = tap % k;
          const int toff = (dx * H + dy) * H + dz;
          const bf16* wb = ws + (tap & 1) * NT * RS;
#pragma unroll
          for (int kk = 0; kk < CK; kk += 16) {
            uint32_t bf[NT / 8][2];
#pragma unroll
            for (int jp = 0; jp < NT / 16; ++jp) {
              uint32_t r4[4];
              ldsm_x4(r4, smem_u32(wb + (jp * 16 + b_row) * RS + kk + b_coff));
              bf[2 * jp][0] = r4[0];
              bf[2 * jp][1] = r4[1];
              bf[2 * jp + 1][0] = r4[2];
              bf[2 * jp + 1][1] = r4[3];
            }
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
              uint32_t a[4];
              ldsm_x4(a, smem_u32(hal + (size_t)(hbase[mt] + toff) * RS + kk + a_coff));
#pragma unroll
              for (int j = 0; j < NT / 8; ++j) mma_bf16(acc[mt][j], a, bf[j][0], bf[j][1]);
            }
          }
        }
        __syncthreads();
      }
    }
  }

  // epilogue: every row of the block's tiles is written (zeros where idle)
  const int r = r0 + tile_s;
  if (r >= R) return;
  bf16* obase = out + ((size_t)r * b3 + lrow) * Cout;
  const bool even = (Cout % 2) == 0;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int col = n0 + j * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        bf16* o = obase + (size_t)(mt * 16 + g + half * 8) * Cout + col;
        const float lo = acc[mt][j][2 * half], hi = acc[mt][j][2 * half + 1];
        if (even) {
          if (col < Cout) *reinterpret_cast<uint32_t*>(o) = pack_bf16(lo, hi);
        } else {
          if (col < Cout) o[0] = __float2bfloat16(lo);
          if (col + 1 < Cout) o[1] = __float2bfloat16(hi);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- weight gradient

// list[0..count) = the occupied tiles (r < m, nbr[r, 13] == r) in increasing
// order; one block.
__global__ void __launch_bounds__(1024) occupied_list_kernel(const int32_t* __restrict__ nbr, int m,
                                                             int32_t* __restrict__ list,
                                                             int32_t* __restrict__ count) {
  __shared__ int warp_off[33];  // exclusive offset of each warp in this pass; [32] the pass's total
  __shared__ int base;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nwarps = blockDim.x / 32;
  if (threadIdx.x == 0) base = 0;
  __syncthreads();
  for (int start = 0; start < m; start += blockDim.x) {
    const int r = start + threadIdx.x;
    const bool occ = r < m && nbr[(size_t)r * 27 + 13] == r;
    const unsigned mask = __ballot_sync(0xffffffffu, occ);
    const int pre = __popc(mask & ((1u << lane) - 1u));
    if (lane == 0) warp_off[warp] = __popc(mask);
    __syncthreads();
    if (warp == 0) {
      const int v = lane < nwarps ? warp_off[lane] : 0;
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      warp_off[lane] = incl - v;
      if (lane == 31) warp_off[32] = incl;
    }
    __syncthreads();
    if (occ) list[base + warp_off[warp] + pre] = r;
    __syncthreads();
    if (threadIdx.x == 0) base += warp_off[32];
    __syncthreads();
  }
  if (threadIdx.x == 0) *count = base;
}

template <int NT, int CK>
__global__ void __launch_bounds__(32 * kDwWarps) tap_conv_dw_kernel(
    const bf16* __restrict__ dense, const int32_t* __restrict__ nbr, const bf16* __restrict__ gout,
    const int32_t* __restrict__ list, const int32_t* __restrict__ count,
    float* __restrict__ partial,  // [P, k^3, Cin_p, Cout_p]
    int m, int b, int k, int Cin, int Cin_p, int Cout, int Cout_p, int tpb, int P) {
  constexpr int RA = CK + kPadE;  // halo row stride
  constexpr int RG = NT + kPadE;  // cotangent row stride
  extern __shared__ __align__(16) unsigned char smem[];
  const int b3 = b * b * b, h = (k - 1) / 2, H = b + 2 * h, H3 = H * H * H, K3 = k * k * k;
  bf16* hal = reinterpret_cast<bf16*>(smem);                 // [tpb][H3][RA]
  bf16* gs = hal + (size_t)tpb * H3 * RA;                    // [tpb * b3][RG]
  int* nb = reinterpret_cast<int*>(gs + (size_t)tpb * b3 * RG);  // [tpb][27]
  int* tiles = nb + tpb * 27;                                     // [tpb]

  const int nci = Cin_p / CK, nco = Cout_p / NT;
  const int tg = blockIdx.x / (nci * nco);
  const int ci0 = ((blockIdx.x / nco) % nci) * CK;
  const int n0 = (blockIdx.x % nco) * NT;
  const int p = blockIdx.y;
  const int cnt = *count;
  const int lo = (int)((long long)cnt * p / P), hi = (int)((long long)cnt * (p + 1) / P);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // the warp's taps: tg * kDwTaps + j * kDwWarps + warp, so a last partial
  // group spreads its taps over all warps
  int toff[kDwTapsPerWarp];
  bool tok[kDwTapsPerWarp];
#pragma unroll
  for (int j = 0; j < kDwTapsPerWarp; ++j) {
    const int tap = tg * kDwTaps + j * kDwWarps + warp;
    const int dx = tap / (k * k), dy = (tap / k) % k, dz = tap % k;
    tok[j] = tap < K3;
    toff[j] = (dx * H + dy) * H + dz;
  }

  float acc[kDwTapsPerWarp][CK / 16][NT / 8][4];
#pragma unroll
  for (int j = 0; j < kDwTapsPerWarp; ++j)
#pragma unroll
    for (int i = 0; i < CK / 16; ++i)
#pragma unroll
      for (int n = 0; n < NT / 8; ++n) acc[j][i][n][0] = acc[j][i][n][1] = acc[j][i][n][2] = acc[j][i][n][3] = 0.f;

  // ldmatrix.trans lanes. A (rows ci, cols voxel): matrix j holds voxels
  // (j >> 1) * 8.. and channels (j & 1) * 8..; B (rows voxel, cols co): matrix
  // j holds voxels (j & 1) * 8.. and channels (j >> 1) * 8..
  const int a_vox = ((lane >> 4) & 1) * 8 + (lane & 7), a_coff = ((lane >> 3) & 1) * 8;
  const int b_vox = ((lane >> 3) & 1) * 8 + (lane & 7), b_coff = ((lane >> 4) & 1) * 8;
  const bool gvec = (Cout % 8) == 0;

  for (int q0 = lo; q0 < hi; q0 += tpb) {
    const int nt = min(tpb, hi - q0);
    __syncthreads();
    for (int s = threadIdx.x; s < tpb; s += blockDim.x) tiles[s] = s < nt ? list[q0 + s] : -1;
    for (int i = threadIdx.x; i < tpb * 27; i += blockDim.x) {
      const int s = i / 27;
      nb[i] = s < nt ? nbr[(size_t)list[q0 + s] * 27 + i % 27] : m;
    }
    __syncthreads();
    stage_halo<CK>(hal, nb, nullptr, nt, dense, b, h, H, Cin, ci0);
    constexpr int GV = NT / 8;
    for (int i = threadIdx.x; i < tpb * b3 * GV; i += blockDim.x) {
      const int q = i % GV, row = i / GV, s = row / b3;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (s < nt) v = load8(gout, (size_t)tiles[s] * b3 + row % b3, Cout, n0 + q * 8, gvec);
      *reinterpret_cast<uint4*>(gs + (size_t)row * RG + q * 8) = v;
    }
    __syncthreads();
    if (!tok[0]) continue;  // the warp has no tap (its first is its lowest)
    for (int s = 0; s < nt; ++s) {
      for (int v0 = 0; v0 < b3; v0 += 16) {
        // the cotangent's fragments, shared by the warp's taps
        uint32_t bfr[NT / 16][4];
        const bf16* grow = gs + ((size_t)s * b3 + v0 + b_vox) * RG + b_coff;
#pragma unroll
        for (int jp = 0; jp < NT / 16; ++jp) ldsm_x4_trans(bfr[jp], smem_u32(grow + jp * 16));
        const int v = v0 + a_vox;
        const int ox = v / (b * b), oy = (v / b) % b, oz = v % b;
        const bf16* abase = hal + ((size_t)s * H3 + (ox * H + oy) * H + oz) * RA + a_coff;
#pragma unroll
        for (int j = 0; j < kDwTapsPerWarp; ++j) {
          if (!tok[j]) continue;
          uint32_t af[CK / 16][4];
#pragma unroll
          for (int mi = 0; mi < CK / 16; ++mi)
            ldsm_x4_trans(af[mi], smem_u32(abase + (size_t)toff[j] * RA + mi * 16));
#pragma unroll
          for (int jp = 0; jp < NT / 16; ++jp)
#pragma unroll
            for (int mi = 0; mi < CK / 16; ++mi) {
              mma_bf16(acc[j][mi][2 * jp], af[mi], bfr[jp][0], bfr[jp][1]);
              mma_bf16(acc[j][mi][2 * jp + 1], af[mi], bfr[jp][2], bfr[jp][3]);
            }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kDwTapsPerWarp; ++j) {
    if (!tok[j]) continue;
    const int tap = tg * kDwTaps + j * kDwWarps + warp;
    float* base = partial + (((size_t)p * K3 + tap) * Cin_p + ci0) * Cout_p + n0;
#pragma unroll
    for (int mi = 0; mi < CK / 16; ++mi)
#pragma unroll
      for (int n = 0; n < NT / 8; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float2 v = make_float2(acc[j][mi][n][2 * half], acc[j][mi][n][2 * half + 1]);
          *reinterpret_cast<float2*>(base + (size_t)(mi * 16 + g + half * 8) * Cout_p + n * 8 + 2 * t) = v;
        }
  }
}

// dw[tap, ci, co] = sum over p in order of partial[p, tap, ci, co].
__global__ void __launch_bounds__(256) partial_sum_kernel(const float* __restrict__ partial,
                                                          float* __restrict__ dw, int P, int K3,
                                                          int Cin, int Cout, int Cin_p, int Cout_p) {
  const long long total = (long long)K3 * Cin * Cout;
  const size_t stride = (size_t)K3 * Cin_p * Cout_p;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int co = (int)(e % Cout), ci = (int)((e / Cout) % Cin), tap = (int)(e / ((long long)Cout * Cin));
    const size_t off = ((size_t)tap * Cin_p + ci) * Cout_p + co;
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += partial[p * stride + off];
    dw[e] = s;
  }
}

// ---------------------------------------------------------------- launchers

size_t fwd_smem(int NT, int CK, int H3, int tpb) {
  return ((size_t)tpb * H3 * (CK + kPadE) + 2 * (size_t)NT * (CK + kPadE)) * sizeof(bf16) +
         (size_t)tpb * 28 * sizeof(int);
}

size_t dw_smem(int NT, int CK, int H3, int b3, int tpb) {
  return ((size_t)tpb * H3 * (CK + kPadE) + (size_t)tpb * b3 * (NT + kPadE)) * sizeof(bf16) +
         (size_t)tpb * 28 * sizeof(int);
}

template <int NT, int CK>
int launch_fwd(const bf16* dense, const int32_t* nbr, const bf16* wt, bf16* out, int m, int b, int k,
               int Cin, int Cin_p, int Cout, int Cout_p, cudaStream_t s) {
  const int b3 = b * b * b, H = b + k - 1, H3 = H * H * H;
  int tpb = 512 / b3;  // 64 output rows per warp, 8 warps
  while (tpb > 1 && fwd_smem(NT, CK, H3, tpb) > kMaxSmem) tpb /= 2;
  const size_t smem = fwd_smem(NT, CK, H3, tpb);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tap_conv_fwd_kernel<NT, CK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((m + 1 + tpb - 1) / tpb), (unsigned)(Cout_p / NT));
  const int threads = tpb * b3 / 64 * 32;
  tap_conv_fwd_kernel<NT, CK><<<grid, threads, smem, s>>>(dense, nbr, wt, out, m, b, k, Cin, Cin_p,
                                                          Cout, Cout_p, tpb);
  return (int)cudaGetLastError();
}

template <int NT, int CK>
int launch_dw(const bf16* dense, const int32_t* nbr, const bf16* g, int32_t* list, int32_t* count,
              float* partial, float* dw, int m, int b, int k, int Cin, int Cin_p, int Cout, int Cout_p,
              int P, cudaStream_t s) {
  const int b3 = b * b * b, H = b + k - 1, H3 = H * H * H, K3 = k * k * k;
  int tpb = 512 / b3;
  while (tpb > 1 && dw_smem(NT, CK, H3, b3, tpb) > kMaxSmem) tpb /= 2;
  const size_t smem = dw_smem(NT, CK, H3, b3, tpb);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tap_conv_dw_kernel<NT, CK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  occupied_list_kernel<<<1, 1024, 0, s>>>(nbr, m, list, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int groups = (K3 + kDwTaps - 1) / kDwTaps;
  const dim3 grid((unsigned)(groups * (Cin_p / CK) * (Cout_p / NT)), (unsigned)P);
  tap_conv_dw_kernel<NT, CK><<<grid, 32 * kDwWarps, smem, s>>>(dense, nbr, g, list, count, partial,
                                                               m, b, k, Cin, Cin_p, Cout, Cout_p,
                                                               tpb, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)K3 * Cin * Cout;
  const unsigned blocks = (unsigned)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  partial_sum_kernel<<<blocks, 256, 0, s>>>(partial, dw, P, K3, Cin, Cout, Cin_p, Cout_p);
  return (int)cudaGetLastError();
}

bool shape_ok(int b, int k, int m) {
  return (b == 4 || b == 8) && (k == 3 || k == 5) && (k - 1) / 2 <= b && m >= 0;
}

}  // namespace

// dense [(m+1)*b^3, Cin] bf16, nbr [m+1, 27] int32, wt [k^3, Cout_p, Cin_p]
// bf16 (the weight transposed, zero-padded: Cin_p = Cin rounded up to ck,
// Cout_p = Cout rounded up to nt) -> out [(m+1)*b^3, Cout] bf16. ck in
// {16, 32}, nt in {32, 64}. Returns the cudaError_t of the launch.
extern "C" int tap_conv_fwd(const void* dense, const void* nbr, const void* wt, void* out, int m,
                            int b, int k, int Cin, int Cin_p, int Cout, int Cout_p, int nt, int ck,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(b, k, m) || Cin_p % ck != 0 || Cout_p % nt != 0) return (int)cudaErrorInvalidValue;
  const auto* d = static_cast<const bf16*>(dense);
  const auto* n = static_cast<const int32_t*>(nbr);
  const auto* w = static_cast<const bf16*>(wt);
  auto* o = static_cast<bf16*>(out);
  if (nt == 64 && ck == 32) return launch_fwd<64, 32>(d, n, w, o, m, b, k, Cin, Cin_p, Cout, Cout_p, s);
  if (nt == 32 && ck == 32) return launch_fwd<32, 32>(d, n, w, o, m, b, k, Cin, Cin_p, Cout, Cout_p, s);
  if (nt == 64 && ck == 16) return launch_fwd<64, 16>(d, n, w, o, m, b, k, Cin, Cin_p, Cout, Cout_p, s);
  if (nt == 32 && ck == 16) return launch_fwd<32, 16>(d, n, w, o, m, b, k, Cin, Cin_p, Cout, Cout_p, s);
  return (int)cudaErrorInvalidValue;
}

// dense [(m+1)*b^3, Cin] bf16, nbr [m+1, 27] int32, g [(m+1)*b^3, Cout] bf16
// -> dw [k^3, Cin, Cout] f32. Scratch: list [max(m, 1)] int32, count [1]
// int32, partial [P, k^3, Cin_p, Cout_p] f32; nt 32. Returns the cudaError_t
// of the launches.
extern "C" int tap_conv_dw(const void* dense, const void* nbr, const void* g, void* list,
                           void* count, void* partial, void* dw, int m, int b, int k, int Cin,
                           int Cin_p, int Cout, int Cout_p, int nt, int ck, int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(b, k, m) || Cin_p % ck != 0 || Cout_p % nt != 0 || P < 1)
    return (int)cudaErrorInvalidValue;
  const auto* d = static_cast<const bf16*>(dense);
  const auto* n = static_cast<const int32_t*>(nbr);
  const auto* gg = static_cast<const bf16*>(g);
  auto* l = static_cast<int32_t*>(list);
  auto* c = static_cast<int32_t*>(count);
  auto* pp = static_cast<float*>(partial);
  auto* o = static_cast<float*>(dw);
  if (nt == 32 && ck == 32)
    return launch_dw<32, 32>(d, n, gg, l, c, pp, o, m, b, k, Cin, Cin_p, Cout, Cout_p, P, s);
  if (nt == 32 && ck == 16)
    return launch_dw<32, 16>(d, n, gg, l, c, pp, o, m, b, k, Cin, Cin_p, Cout, Cout_p, P, s);
  return (int)cudaErrorInvalidValue;
}
