// Weight-only int8/int4 products at decode shapes: the layer kernels (entry
// kn) and the tied LM head (entry vd).
//
// Replaces: no pallas_call. XLA computes tts_max_tpu/models/quantization.py's
// matmul (:256) and tied_logits (:296), fusing the cast of the int8 or int4
// levels into the product; eager PyTorch would write a bf16 copy of every
// weight on every decode step instead.
//
// What it computes:
//   kn: y[M, N] = x[M, K] @ (levels[K, N] x scale), y in x's dtype, for
//       int8 levels with per-column scales [N], int4 levels (two per byte,
//       low nibble first, two's complement) with per-column scales [N], or
//       int4 levels with grouped scales [K/g, N];
//   vd: logits[M, V] = (h[M, D] . levels[V, D]^T) x scale[V] in fp32, for
//       an int8 or int4 embedding (window).
// Sums are fp32, rounded once to the output dtype.
//
// What bounds it on the H100: bytes. At M <= 16 rows each weight byte is
// used for at most 16 (int8) or 32 (int4) multiply-adds, far below the
// card's ~295 operations per byte: the bound is the levels and scales read
// once over 3.35 TB/s (Llama-3.2-1B's w_gate at int8: 16.8 MB, 5.0 us; the
// tied int8 head window 65542 x 2048: 134 MB, 40 us).
//
// The design (one launch a product; the tensor cores do the multiply-adds):
//   Both entries run mma.m16n8k16 with bf16 operands and fp32 sums. The
//   levels widen exactly to bf16 in registers (int8 through fp32 with the
//   2^23 + (x + 128) trick, int4 as the bf16 136 + level, 0x4300 | (nibble
//   ^ 8), minus 136); the token rows of x are the n8 side (1-8 rows one
//   tile, 9-16 two). bf16 x is exact in bf16; fp32 x goes in as three bf16
//   terms (hi, mid, lo: exact), so every product is exact in fp32. The
//   tensor cores add at most one stage (32 K rows), group or chunk into a
//   fragment, which fp32 adds (grouped: fmaf with the group's scale) carry
//   into the sum, so the sum's rounding does not drift with K.
//   kn: a block of 4 warps owns 128 bytes of every level row (128 int8 or
//       256 int4 columns; for a narrow N, 64 bytes: two warps along N, two
//       sharing each stage's two k-steps) over a K range. Its threads
//       stream that range through an 8-stage cp.async ring in shared
//       memory, 16 bytes a lane (32 rows of the tile a stage, with the
//       stage's x rows and, at the end of a group, the group's scale row; 7
//       stages, 28 KB of levels at 128 bytes, in flight a block), issued
//       with shifts and counters only. Each warp reads its 32 bytes of a stage with
//       ldmatrix.trans, which hands lane (g, t) the pairs along k of two
//       neighbouring columns: the A fragment of W^T with its 16 rows mapped
//       to columns 2g, 2g+1 (int8) or 4g..4g+3 (int4) of the piece and k in
//       order, so no level is moved between lanes and the output columns
//       stay in the lanes that read them. x's fragment comes from the
//       staged rows by ldmatrix (bf16) or two float2 reads split in three.
//       The K ranges of one column tile form a thread-block cluster (1-16
//       blocks; the most the card holds at once for the tile count, asked
//       of cudaOccupancyMaxActiveClusters): each block leaves its sums in
//       its shared memory and the cluster's ranks add them through
//       distributed shared memory in rank order, scale the columns and
//       round once. Fixed orders throughout: repeated launches are bitwise
//       equal.
//   vd: a warp takes 32 vocab rows (two A tiles) and walks D in chunks of
//       two consecutive 16-byte pieces of each row a lane (128 bytes of a
//       row across lanes t = 0..3), loaded straight into registers one
//       chunk ahead. Each 4-byte word of a lane is one k-step's A pairs;
//       the fragment's k slots 2t, 2t+1, 2t+8, 2t+9 are the lane's four
//       consecutive d's, so h, staged once a block as bf16 (or fp32) in
//       shared memory, is read in the same order: 16 bytes a lane serve two
//       k-steps of both A tiles. The row scale multiplies the fp32 sum
//       before the store.
#include <cooperative_groups.h>

#include <type_traits>

#include "mma.cuh"

namespace ttsk {
namespace qmm {

namespace cg = cooperative_groups;
namespace tc = ttsk::mma;

constexpr int KN_WARPS = 4;       // ops/quant_matmul.KN_WARPS
constexpr int KN_THREADS = KN_WARPS * 32;
constexpr int PIECE = 32;         // bytes of a level row a warp takes (int8: 32, int4: 64 columns)
constexpr int STAGE_ROWS = 32;    // ops/quant_matmul.STAGE_ROWS
constexpr int STAGES = 8;         // ops/quant_matmul.STAGES
constexpr int MAX_CLUSTER = 16;   // the largest of ops/quant_matmul.CLUSTERS
constexpr int VD_WARPS = 8;       // ops/quant_matmul.VD_WARPS
constexpr int VD_PIECES = 2;      // ops/quant_matmul.VD_PIECES: 16-byte pieces of a row a lane, a chunk
constexpr int VD_TILES = 2;       // ops/quant_matmul.VD_TILES: A tiles (16 vocab rows) a warp

// A kn block: WN warps side by side along N (a tile of 32 WN bytes of every
// level row: 128 or 64), KW = 4 / WN of them along K (a stage's two k-steps
// split between them).
template <int BITS, int NT, typename T, bool GROUPED, int WN>
struct Kn {
  static constexpr int TERMS = std::is_same<T, float>::value ? 3 : 1;  // bf16 terms of x
  static constexpr int KW = KN_WARPS / WN;
  static constexpr int TILE = PIECE * WN;                     // bytes of a row a block covers
  static constexpr int TLOG = WN == 4 ? 7 : 6;                // log2(TILE)
  static constexpr int W_STRIDE = TILE + 16;  // a staged row, padded: ldmatrix rows hit 8 bank groups
  static constexpr int XR = 8 * NT;                           // staged x rows (zero past M)
  static constexpr int XS = STAGE_ROWS * (int)sizeof(T) + 16;  // bytes of a staged x row
  static constexpr int COLS = TILE * 8 / BITS;                // output columns of a tile
  static constexpr int MC = BITS == 8 ? 2 : 4;                // 16-column A tiles of a warp
  static constexpr int X_OFF = STAGE_ROWS * W_STRIDE;
  static constexpr int S_OFF = X_OFF + XR * XS;
  static constexpr int STAGE = S_OFF + (GROUPED ? COLS * 4 : 0);
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(WN * KW == KN_WARPS && (KW == 1 || KW == 2), "two k-steps a stage");
  static_assert(XR * COLS * 4 <= SMEM, "the block's sums reuse the ring");
};

// Level i of an int8 word u = w ^ 0x80808080 as an fp32, exactly.
__device__ __forceinline__ float i8(uint32_t u, int i) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u + i)) - 8388736.f;  // 2^23 + 128
}

// An ldmatrix.trans word of int8 levels holds (k, c) (k, c+1) (k+1, c)
// (k+1, c+1): the bf16 pairs along k of column c and of column c + 1.
__device__ __forceinline__ void int8_kpairs(uint32_t w, uint32_t& c0, uint32_t& c1) {
  const uint32_t u = w ^ 0x80808080u;
  c0 = tc::pack_bf16(i8(u, 0), i8(u, 2));
  c1 = tc::pack_bf16(i8(u, 1), i8(u, 3));
}

// The int4 levels at bits 0-3 and 16-19 of w as a bf16x2, exactly: 0x4300 |
// (nibble ^ 8) is the bf16 136 + level; 136 is subtracted in bf16x2.
__device__ __forceinline__ uint32_t int4_pair(uint32_t w) {
  const uint32_t v = (w & 0x000F000Fu) ^ 0x43084308u;
  const uint32_t k136 = 0x43084308u;
  __nv_bfloat162 a, b;
  memcpy(&a, &v, 4);
  memcpy(&b, &k136, 4);
  return tc::bits(__hsub2(a, b));
}

template <int NT, int TERMS>
__device__ __forceinline__ void mma_terms(float (&c)[NT][4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[NT][TERMS][2]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int tm = 0; tm < TERMS; ++tm) tc::mma_bf16(c[nt], a, b[nt][tm][0], b[nt][tm][1]);
}

// x's B fragments for k rows kl..kl+15 of a stage: b0 = k 2t, 2t+1 and
// b1 = k 2t+8, 2t+9 of token row g (+8 for the second tile).
template <int NT, typename T, int XS, int TERMS>
__device__ __forceinline__ void kn_b_frags(uint32_t (&b)[NT][TERMS][2], const uint8_t* xs, int kl,
                                           int lane) {
  if constexpr (TERMS == 1) {
    const int kofs = (kl + ((lane >> 3) & 1) * 8) * 2;
    if constexpr (NT == 2) {
      uint32_t v[4];
      tc::ldmatrix_x4(v, xs + ((lane & 7) + (lane >> 4) * 8) * XS + kofs);
      b[0][0][0] = v[0];
      b[0][0][1] = v[1];
      b[1][0][0] = v[2];
      b[1][0][1] = v[3];
    } else {
      uint32_t v[2];
      tc::ldmatrix_x2(v, xs + (lane & 7) * XS + kofs);
      b[0][0][0] = v[0];
      b[0][0][1] = v[1];
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* row = reinterpret_cast<const float*>(xs + (8 * nt + g) * XS);
      const float2 p = *reinterpret_cast<const float2*>(row + kl + 2 * t);
      const float2 p8 = *reinterpret_cast<const float2*>(row + kl + 2 * t + 8);
      tc::split3_bf16(p.x, p.y, b[nt][0][0], b[nt][1][0], b[nt][2][0]);
      tc::split3_bf16(p8.x, p8.y, b[nt][0][1], b[nt][1][1], b[nt][2][1]);
    }
  }
}

// One stage's copies: the tile's bytes of 32 level rows in pieces of
// 1 << vshift bytes (pieces past the row's end read nothing and arrive as
// zeros), the stage's k range of x's M rows, and, when the stage ends a
// group, the group's scale row.
template <int BITS, int NT, typename T, bool GROUPED, int WN>
__device__ __forceinline__ void kn_issue(uint8_t* st, const T* x, const uint8_t* q,
                                         const float* srow, int kr, int M, int K, int N,
                                         int ldq, int byte0, int row_bytes, int vshift,
                                         int svec) {
  using L = Kn<BITS, NT, T, GROUPED, WN>;
  const int tid = threadIdx.x;
  const int rshift = L::TLOG - vshift, vec = 1 << vshift;  // pieces a row: 1 << rshift
  for (int i = tid; i < STAGE_ROWS << rshift; i += KN_THREADS) {
    const int r = i >> rshift, c = (i & ((1 << rshift) - 1)) << vshift;
    const bool live = byte0 + c < row_bytes;
    tc::cp_async_vec(st + r * L::W_STRIDE + c,
                     q + static_cast<size_t>(kr + r) * ldq + (live ? byte0 + c : 0), vec, live);
  }
  constexpr int XCH = STAGE_ROWS * (int)sizeof(T) / 16;  // 16-byte pieces of a row's k range
  if (tid < M * XCH) {
    const int r = tid / XCH, c = tid - r * XCH;
    tc::cp_async16(st + L::X_OFF + r * L::XS + c * 16,
                   reinterpret_cast<const uint8_t*>(x + static_cast<size_t>(r) * K + kr) + c * 16,
                   true);
  }
  if (GROUPED && srow != nullptr) {
    const int col0 = byte0 * 8 / BITS, per = svec / 4;
    for (int i = tid; i < L::COLS / per; i += KN_THREADS) {
      const int n = col0 + i * per;
      tc::cp_async_vec(st + L::S_OFF + i * svec, srow + (n < N ? n : 0), svec, n < N);
    }
  }
}

template <int BITS, int NT, typename T, bool GROUPED, int WN>
__global__ void __launch_bounds__(KN_THREADS, sizeof(T) == 4 ? 3 : 4)
    kn_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
              const float* __restrict__ scale, T* __restrict__ y, int M, int K, int N, int ldq,
              int group, int krange, int vshift, int svec) {
  using L = Kn<BITS, NT, T, GROUPED, WN>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp % WN, wk = warp / WN;  // the warp's piece of the tile, its k-steps
  const int k0 = blockIdx.y * krange;  // this block's K range (its cluster rank): whole groups
  const int byte0 = blockIdx.x * L::TILE;
  const int row_bytes = N * BITS / 8;
  const int nst = krange / STAGE_ROWS;
  const int gst = GROUPED ? group / STAGE_ROWS : 1;  // stages a group
  // Stages are issued in order; the one that ends a group also copies the
  // group's scale row (the next one of this block's groups).
  int issued = 0;
  const float* next_srow = GROUPED ? scale + static_cast<size_t>(k0 / group) * N : nullptr;
  auto issue = [&](int s) {
    const float* srow = nullptr;
    if (GROUPED && ++issued == gst) {
      issued = 0;
      srow = next_srow;
      next_srow += N;
    }
    kn_issue<BITS, NT, T, GROUPED, WN>(smem + (s % STAGES) * L::STAGE, x, q, srow,
                                       k0 + s * STAGE_ROWS, M, K, N, ldq, byte0, row_bytes,
                                       vshift, svec);
  };

  // x rows M.. of every slot stay zero (the copies never write them)
  constexpr int XQ = L::XR * L::XS / 16;
  for (int i = tid; i < STAGES * XQ; i += KN_THREADS) {
    const int s = i / XQ, j = i - s * XQ;
    if (j / (L::XS / 16) >= M)
      reinterpret_cast<uint4*>(smem + s * L::STAGE + L::X_OFF)[j] = make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll 1
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) issue(s);
    tc::cp_async_commit();
  }

  float acc[L::MC][NT][4], part[L::MC][NT][4];
#pragma unroll
  for (int i = 0; i < L::MC; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][nt][c] = part[i][nt][c] = 0.f;

  int gcount = 0;  // stages of the current group done
#pragma unroll 1
  for (int s = 0; s < nst; ++s) {
    tc::cp_async_wait<STAGES - 2>();  // stage s has landed for this thread ...
    __syncthreads();                  // ... for all, and stage s - 1's slot is free
    if (s + STAGES - 1 < nst) issue(s + STAGES - 1);
    tc::cp_async_commit();

    const uint8_t* st = smem + (s % STAGES) * L::STAGE;
#pragma unroll
    for (int j2 = 0; j2 < 2 / L::KW; ++j2) {
      const int kl = 16 * (wk + L::KW * j2);  // this warp's k-steps of the stage
      // r[0], r[1]: k rows kl..kl+7, kl+8..kl+15 of bytes 32 wn + 0..15;
      // r[2], r[3]: the same rows of bytes 32 wn + 16..31
      uint32_t r[4];
      tc::ldmatrix_x4_trans(
          r, st + (kl + (lane & 7) + ((lane >> 3) & 1) * 8) * L::W_STRIDE + wn * PIECE +
                 (lane >> 4) * 16);
      uint32_t b[NT][L::TERMS][2];
      kn_b_frags<NT, T, L::XS, L::TERMS>(b, st + L::X_OFF, kl, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if constexpr (BITS == 8) {  // A rows g, g + 8: columns 2g, 2g + 1 of the piece
          uint32_t a[4];
          int8_kpairs(r[2 * j], a[0], a[1]);
          int8_kpairs(r[2 * j + 1], a[2], a[3]);
          mma_terms<NT, L::TERMS>(part[j], a, b);
        } else {  // columns 4g, 4g + 1 (the low and high nibble of byte 2g), then 4g + 2, 4g + 3
          const uint32_t lo = r[2 * j], hi = r[2 * j + 1];
          const uint32_t aa[4] = {int4_pair(lo), int4_pair(lo >> 4), int4_pair(hi),
                                  int4_pair(hi >> 4)};
          const uint32_t ab[4] = {int4_pair(lo >> 8), int4_pair(lo >> 12), int4_pair(hi >> 8),
                                  int4_pair(hi >> 12)};
          mma_terms<NT, L::TERMS>(part[2 * j], aa, b);
          mma_terms<NT, L::TERMS>(part[2 * j + 1], ab, b);
        }
      }
    }
    if constexpr (GROUPED) {  // a group ends with this stage: its sums x its scales
      if (++gcount == gst) {
        gcount = 0;
        const float* ss = reinterpret_cast<const float*>(st + L::S_OFF);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 sv = *reinterpret_cast<const float4*>(ss + 64 * wn + 32 * j + 4 * g);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            float(&pa)[4] = part[2 * j][nt];
            float(&pb)[4] = part[2 * j + 1][nt];
            float(&ca)[4] = acc[2 * j][nt];
            float(&cb)[4] = acc[2 * j + 1][nt];
            ca[0] = fmaf(pa[0], sv.x, ca[0]);
            ca[1] = fmaf(pa[1], sv.x, ca[1]);
            ca[2] = fmaf(pa[2], sv.y, ca[2]);
            ca[3] = fmaf(pa[3], sv.y, ca[3]);
            cb[0] = fmaf(pb[0], sv.z, cb[0]);
            cb[1] = fmaf(pb[1], sv.z, cb[1]);
            cb[2] = fmaf(pb[2], sv.w, cb[2]);
            cb[3] = fmaf(pb[3], sv.w, cb[3]);
#pragma unroll
            for (int c = 0; c < 4; ++c) pa[c] = pb[c] = 0.f;
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < L::MC; ++i)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[i][nt][c] += part[i][nt][c];
            part[i][nt][c] = 0.f;
          }
    }
  }

  // this block's sums -> its shared memory, [token][column of the tile]; the
  // KW warps of a piece added in k order
  tc::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll 1
  for (int kw = 0; kw < L::KW; ++kw) {
    if (wk == kw) {
#pragma unroll
      for (int i = 0; i < L::MC; ++i) {
        const int col = BITS == 8 ? 32 * wn + 16 * i + 2 * g
                                  : 64 * wn + 32 * (i >> 1) + 4 * g + 2 * (i & 1);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // tokens 8 nt + 2t, + 1: c[h], c[h + 2]
            float2* dst = reinterpret_cast<float2*>(red + (8 * nt + 2 * t + h) * L::COLS + col);
            float2 v = make_float2(acc[i][nt][h], acc[i][nt][h + 2]);
            if (kw > 0) v = make_float2(dst->x + v.x, dst->y + v.y);
            *dst = v;
          }
        }
      }
    }
    if (L::KW > 1) __syncthreads();
  }
  // the cluster's ranks (K ranges) added in rank order; rank r finishes
  // every cs-th run of 128 outputs
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int cs = gridDim.y;
  const int col0 = byte0 * 8 / BITS;
  for (int e = blockIdx.y * KN_THREADS + tid; e < M * L::COLS; e += cs * KN_THREADS) {
    float sum = 0.f;
    for (int rk = 0; rk < cs; ++rk) sum += cluster.map_shared_rank(red, rk)[e];
    const int tok = e / L::COLS, n = col0 + (e - tok * L::COLS);
    if (n < N) store(y + static_cast<size_t>(tok) * N + n, GROUPED ? sum : sum * __ldg(scale + n));
  }
  cluster.sync();  // no block leaves while another reads its sums
}

// Sets an instantiation's attributes once a device (dynamic shared memory,
// clusters of up to 16) and fills its launch config for cs K splits.
template <int BITS, int NT, typename T, bool GROUPED, int WN>
cudaError_t kn_config(int tiles, int cs, cudaStream_t stream, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute& attr) {
  using L = Kn<BITS, NT, T, GROUPED, WN>;
  auto kern = kn_kernel<BITS, NT, T, GROUPED, WN>;
  static unsigned ready = 0;  // devices whose attributes are set, a bit each
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(ready >> dev & 1u)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    ready |= 1u << dev;
  }
  cfg = {};
  cfg.gridDim = dim3(tiles, cs, 1);
  cfg.blockDim = dim3(KN_THREADS, 1, 1);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = cs;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

struct KnArgs {
  const void *x, *q, *scale;
  void* y;
  int M, K, N, ldq, group, cs, tiles, vshift, svec;
  cudaStream_t stream;
  int* clusters;  // non-null: report the clusters the card holds at once instead of launching
};

template <int BITS, int NT, typename T, bool GROUPED, int WN>
cudaError_t run_kn(const KnArgs& a) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = kn_config<BITS, NT, T, GROUPED, WN>(a.tiles, a.cs, a.stream, cfg, attr);
  if (err != cudaSuccess) return err;
  auto kern = kn_kernel<BITS, NT, T, GROUPED, WN>;
  if (a.clusters != nullptr) return cudaOccupancyMaxActiveClusters(a.clusters, kern, &cfg);
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(a.x),
                           static_cast<const uint8_t*>(a.q), static_cast<const float*>(a.scale),
                           static_cast<T*>(a.y), a.M, a.K, a.N, a.ldq, a.group, a.K / a.cs,
                           a.vshift, a.svec);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int BITS, typename T>
cudaError_t kn_dispatch(int nt, int wn, const KnArgs& a) {
#define TTSK_KN(G)                                                         \
  if (nt == 1) return wn == 4 ? run_kn<BITS, 1, T, G, 4>(a) : run_kn<BITS, 1, T, G, 2>(a); \
  return wn == 4 ? run_kn<BITS, 2, T, G, 4>(a) : run_kn<BITS, 2, T, G, 2>(a);
  if constexpr (BITS == 4) {
    if (a.group > 0) {
      TTSK_KN(true)
    }
  }
  TTSK_KN(false)
#undef TTSK_KN
}

// --- vd ----------------------------------------------------------------------

template <int BITS, int NT, typename T>
struct Vd {
  static constexpr int TERMS = std::is_same<T, float>::value ? 3 : 1;
  static constexpr int XR = 8 * NT;
  static constexpr int CHUNK = 64 * VD_PIECES;           // bytes of a row a chunk (4 lanes)
  static constexpr int LANE_D = 128 * VD_PIECES / BITS;  // d's under a lane's 16-byte pieces
  static constexpr int CHUNK_D = 4 * LANE_D;
  static constexpr int PSTEPS = 32 / BITS;         // k-steps of a 16-byte piece: 4 or 8
  static constexpr int STEPS = VD_PIECES * PSTEPS;       // k-steps of a chunk
};

// Where element d of a staged row of h lies: 8 elements of padding after
// every 64 (ops/quant_matmul.vd_row_stride picks the row stride), so that
// the 16-byte reads of a phase fall in 8 different groups of banks.
__device__ __forceinline__ int hpos(int d) { return d + 8 * (d >> 6); }

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint4 ld_stream(const uint8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// The A pairs of k-step s of a 16-byte piece of one row: int8, word s
// (d's 4s..4s+3: (4s, 4s+1) and (4s+2, 4s+3)); int4, bytes 2s and 2s + 1
// (each byte's low then high nibble).
template <int BITS>
__device__ __forceinline__ void vd_pairs(const uint4& v, int s, uint32_t& lo, uint32_t& hi) {
  if constexpr (BITS == 8) {
    tc::int8x4_to_bf16(word(v, s), lo, hi);
  } else {
    const uint32_t w = word(v, s >> 1), w4 = w >> 4;
    const int b = 2 * (s & 1);
    lo = int4_pair(__byte_perm(w, w4, b | (b << 4) | ((4 + b) << 8) | ((4 + b) << 12)));
    hi = int4_pair(__byte_perm(w, w4, (b + 1) | ((b + 1) << 4) | ((5 + b) << 8) | ((5 + b) << 12)));
  }
}

// A warp takes VD_TILES A tiles (16 vocab rows each); a chunk is VD_PIECES
// consecutive 16-byte pieces of each row a lane (t = 0..3 side by side),
// loaded one chunk ahead.
template <int BITS, int NT, typename T>
__global__ void __launch_bounds__(VD_WARPS * 32, sizeof(T) == 4 && NT == 2 ? 1 : 2)
    vd_kernel(const T* __restrict__ h, const uint8_t* __restrict__ q,
              const float* __restrict__ scale, float* __restrict__ out, int M, int D, int V,
              int hs) {
  using L = Vd<BITS, NT, T>;
  constexpr int VT = VD_TILES, LPR = VD_PIECES;
  extern __shared__ __align__(16) uint8_t smem[];
  T* hsm = reinterpret_cast<T*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row_bytes = D * BITS / 8;
  const int nch = (row_bytes + L::CHUNK - 1) / L::CHUNK;
  const int tasks = (V + 16 * VT - 1) / (16 * VT);
  const int stride = gridDim.x * VD_WARPS;
  int task = blockIdx.x * VD_WARPS + warp;

  const uint8_t* rp[VT][2];  // rows g and g + 8 of each A tile (clamped), at the lane's bytes
  uint4 cur[VT][2][LPR];
#define TTSK_VD_ROWS(TASK)                                                              \
  _Pragma("unroll") for (int vt = 0; vt < VT; ++vt)                                      \
  _Pragma("unroll") for (int hh = 0; hh < 2; ++hh) {                                     \
    const int v = min((TASK) * 16 * VT + 16 * vt + g + 8 * hh, V - 1);                   \
    rp[vt][hh] = q + static_cast<size_t>(v) * row_bytes + 16 * LPR * t;                  \
  }
#define TTSK_VD_LOAD(BUF, C)                                                            \
  _Pragma("unroll") for (int u = 0; u < LPR; ++u) {                                      \
    const bool live = (C) * L::CHUNK + 16 * (LPR * t + u) < row_bytes;                   \
    _Pragma("unroll") for (int vt = 0; vt < VT; ++vt)                                    \
    _Pragma("unroll") for (int hh = 0; hh < 2; ++hh)                                     \
      BUF[vt][hh][u] = live ? ld_stream(rp[vt][hh] + (C) * L::CHUNK + 16 * u)            \
                            : make_uint4(0u, 0u, 0u, 0u);                                \
  }
  TTSK_VD_ROWS(task)
  TTSK_VD_LOAD(cur, 0)  // the first chunk is in flight while h is staged

  // h as T, [XR rows][hs], zero past M and past D (to whole chunks)
  {
    constexpr int PER = 16 / (int)sizeof(T);
    const int dc = (D + L::CHUNK_D - 1) / L::CHUNK_D * L::CHUNK_D, pieces = dc / PER;
    for (int i = threadIdx.x; i < L::XR * pieces; i += VD_WARPS * 32) {
      const int m = i / pieces, d = (i - m * pieces) * PER;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M && d < D) v = *reinterpret_cast<const uint4*>(h + static_cast<size_t>(m) * D + d);
      *reinterpret_cast<uint4*>(hsm + m * hs + hpos(d)) = v;
    }
  }
  __syncthreads();

  bool first = true;
#pragma unroll 1
  for (; task < tasks; task += stride) {
    if (!first) {
      TTSK_VD_ROWS(task)
      TTSK_VD_LOAD(cur, 0)
    }
    first = false;
    float acc[VT][NT][4], part[VT][NT][4];
#pragma unroll
    for (int vt = 0; vt < VT; ++vt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[vt][nt][c] = part[vt][nt][c] = 0.f;
#pragma unroll 1
    for (int c = 0; c < nch; ++c) {
      uint4 nxt[VT][2][LPR];
      if (c + 1 < nch) {
        TTSK_VD_LOAD(nxt, c + 1)
      } else {
#pragma unroll
        for (int u = 0; u < LPR; ++u)
#pragma unroll
          for (int vt = 0; vt < VT; ++vt) nxt[vt][0][u] = nxt[vt][1][u] = cur[vt][0][u];
      }
      const int d0 = c * L::CHUNK_D + t * L::LANE_D;  // the lane's first d of the chunk
#pragma unroll
      for (int s2 = 0; s2 < L::STEPS; s2 += 2) {  // two k-steps: 8 d's of the lane
        uint32_t b[2][NT][L::TERMS][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const T* hrow = hsm + (8 * nt + g) * hs + hpos(d0 + 4 * s2);
          if constexpr (L::TERMS == 1) {
            const uint4 hv = *reinterpret_cast<const uint4*>(hrow);
            b[0][nt][0][0] = hv.x;
            b[0][nt][0][1] = hv.y;
            b[1][nt][0][0] = hv.z;
            b[1][nt][0][1] = hv.w;
          } else {
#pragma unroll
            for (int ss = 0; ss < 2; ++ss) {
              const float4 f = *reinterpret_cast<const float4*>(
                  reinterpret_cast<const float*>(hrow) + 4 * ss);
              tc::split3_bf16(f.x, f.y, b[ss][nt][0][0], b[ss][nt][1][0], b[ss][nt][2][0]);
              tc::split3_bf16(f.z, f.w, b[ss][nt][0][1], b[ss][nt][1][1], b[ss][nt][2][1]);
            }
          }
        }
#pragma unroll
        for (int ss = 0; ss < 2; ++ss) {
          const int s = s2 + ss, u = s / L::PSTEPS, sp = s % L::PSTEPS;
#pragma unroll
          for (int vt = 0; vt < VT; ++vt) {
            uint32_t a[4];  // a[0], a[2]: row g; a[1], a[3]: row g + 8
            vd_pairs<BITS>(cur[vt][0][u], sp, a[0], a[2]);
            vd_pairs<BITS>(cur[vt][1][u], sp, a[1], a[3]);
            mma_terms<NT, L::TERMS>(part[vt], a, b[ss]);
          }
        }
      }
#pragma unroll
      for (int vt = 0; vt < VT; ++vt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[vt][nt][k] += part[vt][nt][k];
            part[vt][nt][k] = 0.f;
          }
#pragma unroll
        for (int u = 0; u < LPR; ++u) {
          cur[vt][0][u] = nxt[vt][0][u];
          cur[vt][1][u] = nxt[vt][1][u];
        }
      }
    }
    const int v0 = task * 16 * VT;
#pragma unroll
    for (int vt = 0; vt < VT; ++vt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int v = v0 + 16 * vt + g + 8 * hh;
        if (v < V) {
          const float sv = __ldg(scale + v);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int tok = 8 * nt + 2 * t;
            if (tok < M) out[static_cast<size_t>(tok) * V + v] = acc[vt][nt][2 * hh] * sv;
            if (tok + 1 < M)
              out[static_cast<size_t>(tok + 1) * V + v] = acc[vt][nt][2 * hh + 1] * sv;
          }
        }
      }
  }
#undef TTSK_VD_ROWS
#undef TTSK_VD_LOAD
}

template <int BITS, int NT, typename T>
cudaError_t launch_vd(const void* h, const void* q, const void* scale, void* out, int M, int D,
                      int V, int hs, int blocks, cudaStream_t stream) {
  auto kern = vd_kernel<BITS, NT, T>;
  const int smem = 8 * NT * hs * static_cast<int>(sizeof(T));
  static int smem_set = 48 * 1024;  // the most this instantiation was allowed so far
  if (smem > smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  kern<<<blocks, VD_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const uint8_t*>(q), static_cast<const float*>(scale),
      static_cast<float*>(out), M, D, V, hs);
  return cudaGetLastError();
}

template <int BITS, typename T>
cudaError_t vd_dispatch(int nt, const void* h, const void* q, const void* scale, void* out,
                        int M, int D, int V, int hs, int blocks, cudaStream_t s) {
  return nt == 1 ? launch_vd<BITS, 1, T>(h, q, scale, out, M, D, V, hs, blocks, s)
                 : launch_vd<BITS, 2, T>(h, q, scale, out, M, D, V, hs, blocks, s);
}

}  // namespace qmm
}  // namespace ttsk

static int kn_entry(int bits, int x_dtype, int nt, int wn, const ttsk::qmm::KnArgs& a) {
  using namespace ttsk::qmm;
  if ((nt != 1 && nt != 2) || (wn != 2 && wn != 4) || a.cs < 1 || a.cs > MAX_CLUSTER ||
      (bits != 4 && bits != 8) || (a.group > 0 && bits != 4) || (x_dtype != 0 && x_dtype != 1))
    return cudaErrorInvalidValue;
  if (bits == 8)
    return x_dtype ? kn_dispatch<8, __nv_bfloat16>(nt, wn, a) : kn_dispatch<8, float>(nt, wn, a);
  return x_dtype ? kn_dispatch<4, __nv_bfloat16>(nt, wn, a) : kn_dispatch<4, float>(nt, wn, a);
}

// kn: x [M, K] (fp32 x_dtype 0, bf16 1; rows 16-byte aligned), levels with
// row stride ldq bytes (pieces of 1 << vshift = 16, 8 or 4 bytes dividing
// ldq and the base address), scale [N] or grouped [K/group, N] (group > 0,
// int4; svec 16 when N % 4 == 0 and the base is 16-byte aligned, else 4),
// y [M, N] in x's dtype. nt (x rows in tiles of 8), wn (warps along N: 32 wn
// bytes a tile), cs (cluster size: K splits) and tiles come from
// ops/quant_matmul.plan. Returns the launch's error.
extern "C" int quant_matmul_kn(const void* x, const void* q, const void* scale, void* y, int M,
                               int K, int N, int ldq, int bits, int group, int nt, int wn,
                               int cs, int tiles, int vshift, int svec, int x_dtype,
                               void* stream) {
  using namespace ttsk::qmm;
  if (M < 1 || M > 8 * nt || cs < 1 || K % (cs * STAGE_ROWS) || vshift < 2 || vshift > 4 ||
      ldq % (1 << vshift) || (svec != 4 && svec != 16) ||
      static_cast<long long>(tiles) * PIECE * wn < static_cast<long long>(N) * bits / 8 ||
      (group > 0 && (group % STAGE_ROWS || (K / cs) % group)))
    return cudaErrorInvalidValue;
  const KnArgs a{x, q, scale, y, M, K, N, ldq, group, cs, tiles, vshift, svec,
                 static_cast<cudaStream_t>(stream), nullptr};
  return kn_entry(bits, x_dtype, nt, wn, a);
}

// How many clusters of cs kn blocks (bits, grouped, x_dtype, nt, wn as
// quant_matmul_kn) the current card holds at once, into *n.
extern "C" int quant_matmul_kn_clusters(int bits, int grouped, int x_dtype, int nt, int wn,
                                        int cs, int* n) {
  using namespace ttsk::qmm;
  const KnArgs a{nullptr, nullptr, nullptr, nullptr, 1, 0, 0, 0, grouped ? STAGE_ROWS : 0,
                 cs, 1, 4, 16, nullptr, n};
  return kn_entry(bits, x_dtype, nt, wn, a);
}

// vd: h [M, D] (fp32 or bf16, D a multiple of 32, rows 16-byte aligned),
// levels [V, D * bits / 8] contiguous with 16-byte aligned rows of a
// multiple of 16 bytes, scale [V], out [M, V] fp32. nt as kn; hs, the
// staged row stride (ops/quant_matmul.vd_row_stride), sets 8 nt hs
// elements of shared memory. Returns the launch's error.
extern "C" int quant_matmul_vd(const void* h, const void* q, const void* scale, void* out, int M,
                               int D, int V, int bits, int nt, int hs, int blocks, int x_dtype,
                               void* stream) {
  using namespace ttsk::qmm;
  if (M < 1 || (nt != 1 && nt != 2) || M > 8 * nt || D % 32 || (D * bits / 8) % 16 ||
      blocks < 1 || hs % (x_dtype == 1 ? 8 : 4) || (bits != 4 && bits != 8))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 8 && x_dtype == 0)
    return vd_dispatch<8, float>(nt, h, q, scale, out, M, D, V, hs, blocks, s);
  if (bits == 8 && x_dtype == 1)
    return vd_dispatch<8, __nv_bfloat16>(nt, h, q, scale, out, M, D, V, hs, blocks, s);
  if (bits == 4 && x_dtype == 0)
    return vd_dispatch<4, float>(nt, h, q, scale, out, M, D, V, hs, blocks, s);
  if (bits == 4 && x_dtype == 1)
    return vd_dispatch<4, __nv_bfloat16>(nt, h, q, scale, out, M, D, V, hs, blocks, s);
  return cudaErrorInvalidValue;
}
