// Kernel A': the backward of causal flash attention (kernel A), for training.
//
// Replaces: tts_max_tpu/ops/pallas_attention.py, the custom_vjp backward _bwd
// of flash_attention (an XLA recompute of _reference_attention), and the
// Pallas dq/dkv kernels of the bundled TPU flash attention that
// tts_max_tpu/ops/attention.py runs under implementation="tpu_flash".
//
// What it computes: the exact gradient of kernel A's function. With
// s_ij = D^-1/2 q_i.k_j, P = softmax_j(s) under the causal mask, O = P V and
// the output cotangent dO:
//   D_i  = sum_d dO_id O_id                      (bwd_delta)
//   dP   = dO V^T,  dS = P o (dP - D_i)
//   dV_j = sum_i P_ij dO_i,  dK_j = D^-1/2 sum_i dS_ij q_i   (dK/dV kernel)
//   dQ_i = D^-1/2 sum_j dS_ij k_j                            (dQ kernel)
// P is recomputed from kernel A's base-2 log-sum-exp (flash_attention.cu):
// P_ij = exp2(log2(e) s_ij - lse_i). GQA: kv head hk serves query heads
// hk*n_rep .. hk*n_rep + n_rep - 1, and dK, dV sum over them inside one block.
// The kv_len rule is the JAX backward's (it cuts q, k, v and dO to kv_len
// rows and pads the gradients back with zeros): query rows at or past kv_len
// add nothing and get dq = 0, key rows past kv_len get dk = dv = 0.
// q, k, v, O, dO in [B, S, H, D]; lse, D in [B, Hq, S]; grads in the inputs'
// dtype, each rounded once from its fp32 sum.
//
// What bounds it on the H100: operations. The backward does five causal
// products (S, dP, dV, dK, dQ: 5 * B * Hq * S^2 * D / 2 multiply-adds, 2.5x
// the forward's) against ~5 * S * H * D * 2 bytes of input; FlashAttention-2's
// split below recomputes S and dP in the dQ kernel, seven products in all.
//
// Deterministic: no atomics, every output element written once. Three
// launches: D, then dK/dV by key tile, then dQ by query tile.
//
// bf16 (bwd_dkdv_tc, bwd_dq_tc: the tensor cores, mma.sync m16n8k16 with
// ldmatrix and a cp.async ring, helpers in mma.cuh, as kernel A's
// flash_fwd_tc). Blocks of 4 warps; a warp owns 16 rows of the block's
// 64-row tile, and the block walks the other side's 64-row tiles through a
// two-stage ring (tile j+1 in flight while tile j is computed; one
// __syncthreads a tile), rows padded by 16 bytes against ldmatrix bank
// conflicts and zero-filled past kv_len by the copy, so no row past kv_len
// brings a NaN that a zero probability would multiply.
//   dK/dV: one block per (64 key rows, kv head, batch), the heaviest key
//     tiles (k0 = 0) first. It streams the group's n_rep query heads and,
//     for each, the query tiles from the diagonal to kv_len, with their
//     lse and D rows. Each warp computes its key rows' transposed scores,
//     S^T = K Q^T and dP^T = V dO^T (Q and dO as B operands by ldmatrix), so
//     P^T and dS^T come out of the C fragments with key rows and go straight
//     into the A fragments of dV += P^T dO and dK += dS^T Q (dO and Q by
//     ldmatrix.trans): no P or dS goes through shared memory. lse and D are
//     per-column values here, read as pairs beside each fragment column.
//   dQ: one block per (64 query rows, query head, batch), heaviest first;
//     Q and dO fragments stay in registers, K and V tiles stream in; S =
//     Q K^T, dP = dO V^T, then dQ += dS K with K read both ways from one
//     shared tile (kernel A's loop with dS in place of P).
// P = exp2 of the scaled score less lse, on the SFU (exp2_fast: relative
// error ~2^-22, far below the bf16 rounding P then takes); positions are
// compared, with selects, only in passes that cross the diagonal or kv_len,
// and a warp skips a pass whose pairs are all masked.
// P and dS enter the tensor cores as bf16, each rounded once: an emulation
// of this arithmetic lies within GRAD_TOL of the plain backward
// (tests/test_torch_tc_numerics.py), unlike kernel A's forward, whose bf16
// output has no tensor-wide atol to hide P's 2^-9 rounding. D reads O as
// kernel A's bf16 output plus its rounding residual o_lo: D from the
// rounded O alone errs by 2^-9 |O| an element, which dS = P (dP - D)
// turns into gradients outside GRAD_TOL under a sharp softmax.
// Registers decide the speed on this card: three 128-thread blocks share an
// SM at up to 170 registers a thread. At D = 64 the dK/dV warp reads its K
// and V A fragments from shared memory rather than holding them, and takes
// 64 query columns a pass (168 registers); the dQ warp takes 32 key columns
// a pass (164). Holding K and V, or a third ring stage, cost the dK/dV
// kernel its third block and ran slower on the H100. At D = 128 the
// accumulators double: both take 32 columns a pass (244 and 248 registers,
// two blocks an SM). ptxas reports no spill (chip_smoke.py logs each
// instantiation's registers).
//
// fp32 (bwd_dkdv, bwd_dq) stays on the CUDA cores, the first design: the
// tensor cores would round fp32 inputs, and the fp32 small-train check runs
// this path. 256 threads as a 16 x 16 grid, each a 4 x 4 (or 4 x 8 at D =
// 128) register micro-tile of each product; tiles staged in shared memory as
// fp32 rows padded by one float; P and dS of a tile pair through shared
// memory.
#include "mma.cuh"

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // key rows per tile
constexpr int NT = 256;  // fp32: a 16 x 16 thread grid
constexpr int RM = 4;    // fp32: micro-tile rows per thread (64 / 16)
constexpr float LOG2E = 1.4426950408889634f;

// D_i = sum_d dO_id (O_id + O_lo_id) for rows < kv_len (0 past it): one warp
// per row. o_lo is kernel A's bf16 rounding residual of O, or null (fp32).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_delta(const T* __restrict__ o, const T* __restrict__ o_lo, const T* __restrict__ g,
          float* __restrict__ delta, int S, int Hq, int kv_len) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (NT / 32) + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= S) return;
  float acc = 0.f;
  if (row < kv_len) {
    const long base = (static_cast<long>(b) * S + row) * Hq * D + static_cast<long>(h) * D;
#pragma unroll
    for (int d = lane; d < D; d += 32) {
      const float ov = ttsk::to_float(o[base + d]) +
                       (o_lo != nullptr ? ttsk::to_float(o_lo[base + d]) : 0.f);
      acc += ov * ttsk::to_float(g[base + d]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) delta[(static_cast<long>(b) * Hq + h) * S + row] = acc;
}

// --- fp32: CUDA cores ---------------------------------------------------------

// Rows [r0, r0 + 64) of the [S, H, D] tensor x at head h into shared fp32
// [64][D + 1], zero past row `end`.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ x, long stride,
                                          int r0, int end) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, c = i % D, s = r0 + r;
    dst[r * (D + 1) + c] = s < end ? x[s * stride + c] : 0.f;
  }
}

// The 4 x 4 micro-tiles of S = A B^T and of dP = A2 B2^T over D, for query
// rows ty + 16 i and key rows tx + 16 j of 64-row shared tiles.
template <int D>
__device__ __forceinline__ void two_products(const float* A, const float* B, const float* A2,
                                             const float* B2, int ty, int tx,
                                             float (&s)[RM][4], float (&dp)[RM][4]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[RM], a2[RM], bb[4], b2[4];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      a[i] = A[(ty + 16 * i) * (D + 1) + d];
      a2[i] = A2[(ty + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bb[j] = B[(tx + 16 * j) * (D + 1) + d];
      b2[j] = B2[(tx + 16 * j) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], bb[j], s[i][j]);
        dp[i][j] = fmaf(a2[i], b2[j], dp[i][j]);
      }
  }
}

// P and dS of one (query tile q0, key tile k0) pair from S and dP: masked to
// key <= query < kv_len (causal; keys past the query are past kv_len too).
__device__ __forceinline__ void probs(float (&s)[RM][4], float (&dp)[RM][4], const float* lse,
                                      const float* dlt, int q0, int k0, int ty, int tx,
                                      int kv_len, float scale2) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 16 * i, qp = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kp = k0 + tx + 16 * j;
      const bool ok = qp < kv_len && kp <= qp;
      const float p = ok ? exp2f(s[i][j] * scale2 - lse[r]) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dlt[r]);
    }
  }
}

template <int D>
constexpr int dkdv_smem_floats() {
  return 4 * 64 * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ;
}

template <int D>
__global__ void __launch_bounds__(NT)
bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
         const float* __restrict__ g, const float* __restrict__ lse,
         const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
         int S, int Hq, int Hkv, int kv_len, float scale) {
  constexpr int CN = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;                  // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);     // [BK][D+1]
  float* Qs = Vs + BK * (D + 1);     // [BQ][D+1]
  float* Gs = Qs + BQ * (D + 1);     // [BQ][D+1] dO
  float* Ps = Gs + BQ * (D + 1);     // [BQ][BK+1]
  float* Ds = Ps + BQ * (BK + 1);    // [BQ][BK+1] dS
  float* Ls = Ds + BQ * (BK + 1);    // [BQ] lse
  float* Dl = Ls + BQ;               // [BQ] D

  const int k0 = blockIdx.x * BK;  // the heaviest key tiles (k0 = 0) come first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int n_rep = Hq / Hkv;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long q_stride = static_cast<long>(Hq) * D;
  const long kv_stride = static_cast<long>(Hkv) * D;
  const long kv_off = static_cast<long>(b) * S * kv_stride + static_cast<long>(hk) * D;

  load_tile<D>(Ks, k + kv_off, kv_stride, k0, kv_len);
  load_tile<D>(Vs, v + kv_off, kv_stride, k0, kv_len);

  float acc_k[RM][CN], acc_v[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < CN; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const float scale2 = scale * LOG2E;
  const int q_tiles = (kv_len + BQ - 1) / BQ;
  for (int r = 0; r < n_rep; ++r) {
    const int h = hk * n_rep + r;
    const long q_off = static_cast<long>(b) * S * q_stride + static_cast<long>(h) * D;
    const float* lse_h = lse + (static_cast<long>(b) * Hq + h) * S;
    const float* dl_h = delta + (static_cast<long>(b) * Hq + h) * S;
    for (int qt = k0 / BQ; qt < q_tiles; ++qt) {  // empty when k0 >= kv_len
      const int q0 = qt * BQ;
      __syncthreads();  // the previous pair's Qs, Gs, Ps, Ds are consumed
      load_tile<D>(Qs, q + q_off, q_stride, q0, kv_len);
      load_tile<D>(Gs, g + q_off, q_stride, q0, kv_len);
      if (threadIdx.x < BQ) {
        const int s = q0 + threadIdx.x;
        Ls[threadIdx.x] = s < kv_len ? lse_h[s] : 0.f;
        Dl[threadIdx.x] = s < kv_len ? dl_h[s] : 0.f;
      }
      __syncthreads();

      float sc[RM][4], dp[RM][4];
      two_products<D>(Qs, Ks, Gs, Vs, ty, tx, sc, dp);
      probs(sc, dp, Ls, Dl, q0, k0, ty, tx, kv_len, scale2);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = sc[i][j];
          Ds[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();

      // dV[j] += sum_i P[i][j] dO[i]; dK[j] += sum_i dS[i][j] q[i]:
      // this thread's key rows ty + 16 i, columns tx + 16 c
#pragma unroll 4
      for (int qi = 0; qi < BQ; ++qi) {
        float p[RM], ds[RM], go[CN], qq[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          p[i] = Ps[qi * (BK + 1) + ty + 16 * i];
          ds[i] = Ds[qi * (BK + 1) + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < CN; ++c) {
          go[c] = Gs[qi * (D + 1) + tx + 16 * c];
          qq[c] = Qs[qi * (D + 1) + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int c = 0; c < CN; ++c) {
            acc_v[i][c] = fmaf(p[i], go[c], acc_v[i][c]);
            acc_k[i][c] = fmaf(ds[i], qq[c], acc_k[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= S) continue;
#pragma unroll
    for (int c = 0; c < CN; ++c) {
      const long idx = kv_off + s * kv_stride + tx + 16 * c;
      dk[idx] = acc_k[i][c] * scale;
      dv[idx] = acc_v[i][c];
    }
  }
}

template <int D>
constexpr int dq_smem_floats() {
  return 4 * 64 * (D + 1) + BQ * (BK + 1) + 2 * BQ;
}

template <int D>
__global__ void __launch_bounds__(NT)
bwd_dq(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
       const float* __restrict__ g, const float* __restrict__ lse,
       const float* __restrict__ delta, float* __restrict__ dq, int S, int Hq, int Hkv,
       int kv_len, float scale) {
  constexpr int CN = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][D+1]
  float* Gs = Qs + BQ * (D + 1);     // [BQ][D+1]
  float* Ks = Gs + BQ * (D + 1);     // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);     // [BK][D+1]
  float* Ds = Vs + BK * (D + 1);     // [BQ][BK+1] dS
  float* Ls = Ds + BQ * (BK + 1);    // [BQ]
  float* Dl = Ls + BQ;               // [BQ]

  const int qt = gridDim.x - 1 - blockIdx.x;  // the heaviest query tiles first
  const int q0 = qt * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long q_stride = static_cast<long>(Hq) * D;
  const long kv_stride = static_cast<long>(Hkv) * D;
  const long q_off = static_cast<long>(b) * S * q_stride + static_cast<long>(h) * D;
  const long kv_off = static_cast<long>(b) * S * kv_stride + static_cast<long>(hk) * D;

  load_tile<D>(Qs, q + q_off, q_stride, q0, kv_len);
  load_tile<D>(Gs, g + q_off, q_stride, q0, kv_len);
  if (threadIdx.x < BQ) {
    const int s = q0 + threadIdx.x;
    const long row = (static_cast<long>(b) * Hq + h) * S + s;
    Ls[threadIdx.x] = s < kv_len ? lse[row] : 0.f;
    Dl[threadIdx.x] = s < kv_len ? delta[row] : 0.f;
  }

  float acc[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[i][c] = 0.f;

  const float scale2 = scale * LOG2E;
  // keys up to the tile's last live row: none when q0 >= kv_len
  const int k_tiles = q0 < kv_len ? min(q0 + BQ, kv_len) / BK + (min(q0 + BQ, kv_len) % BK != 0)
                                  : 0;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks, Vs, Ds are consumed (and Qs, Gs landed)
    load_tile<D>(Ks, k + kv_off, kv_stride, k0, kv_len);
    load_tile<D>(Vs, v + kv_off, kv_stride, k0, kv_len);
    __syncthreads();

    float sc[RM][4], dp[RM][4];
    two_products<D>(Qs, Ks, Gs, Vs, ty, tx, sc, dp);
    probs(sc, dp, Ls, Dl, q0, k0, ty, tx, kv_len, scale2);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ds[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = dp[i][j];
    __syncthreads();

    // dQ[i] += sum_j dS[i][j] k[j]: this thread's query rows ty + 16 i
#pragma unroll 4
    for (int kj = 0; kj < BK; ++kj) {
      float ds[RM], kk[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) ds[i] = Ds[(ty + 16 * i) * (BK + 1) + kj];
#pragma unroll
      for (int c = 0; c < CN; ++c) kk[c] = Ks[kj * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) acc[i][c] = fmaf(ds[i], kk[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
#pragma unroll
    for (int c = 0; c < CN; ++c) dq[q_off + s * q_stride + tx + 16 * c] = acc[i][c] * scale;
  }
}

template <int D>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* o,
                       const float* g, const float* lse, float* delta, float* dq, float* dk,
                       float* dv, int B, int S, int Hq, int Hkv, int kv_len, float scale,
                       cudaStream_t st) {
  bwd_delta<float, D><<<dim3((S + NT / 32 - 1) / (NT / 32), Hq, B), NT, 0, st>>>(
      o, nullptr, g, delta, S, Hq, kv_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int tiles = (S + 63) / 64;
  const int smem_kv = dkdv_smem_floats<D>() * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(bwd_dkdv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return err;
  bwd_dkdv<D><<<dim3(tiles, Hkv, B), NT, smem_kv, st>>>(q, k, v, g, lse, delta, dk, dv, S, Hq,
                                                       Hkv, kv_len, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_q = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return err;
  bwd_dq<D><<<dim3(tiles, Hq, B), NT, smem_q, st>>>(q, k, v, g, lse, delta, dq, S, Hq, Hkv,
                                                   kv_len, scale);
  return cudaGetLastError();
}

// --- bf16: tensor cores -------------------------------------------------------

using bf16 = __nv_bfloat16;
namespace tc = ttsk::mma;

constexpr int TB = 64;                 // rows of a query or key tile
constexpr int TC_WARPS = TB / 16;      // each warp owns 16 rows of the block's tile
constexpr int TC_NT = TC_WARPS * 32;
constexpr int STAGES = 2;              // the ring: tile j+1 in flight while tile j is used
static_assert(TC_NT == 2 * TB, "one thread copies one lse or D value of a tile");

template <int D>
struct TcConfig {
  static constexpr int LD = D + 8;  // padded row: 8 ldmatrix rows hit 8 bank groups
  // score columns a warp takes in one pass: dK/dV 64 at D = 64 (32 at D =
  // 128, where its accumulators double), dQ 32
  static constexpr int CW_KV = D == 64 ? 64 : 32;
  static constexpr int CW_Q = 32;
  static constexpr int TILE = TB * LD;  // bf16 elements of one shared tile
  // dK/dV: K, V, then the ring of Q and dO tiles, then the ring of lse and D rows
  static constexpr int DKDV_SMEM = (2 + 2 * STAGES) * TILE * 2 + 2 * STAGES * TB * 4;
  // dQ: Q, dO, then the ring of K and V tiles
  static constexpr int DQ_SMEM = (2 + 2 * STAGES) * TILE * 2;
};

// Rows [r0, r0 + 64) of a [S, H, D] tensor (src at its head) into a shared
// [64][LD] tile by 16-byte cp.async, rows at or past kv_len zero-filled.
template <int D>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* __restrict__ src, long stride,
                                          int r0, int kv_len) {
  constexpr int LD = TcConfig<D>::LD, CH = D / 8;
  for (int i = threadIdx.x; i < TB * CH; i += TC_NT) {
    const int r = i / CH, c = (i % CH) * 8, s = r0 + r;
    tc::cp_async16(&dst[r * LD + c], src + min(s, kv_len - 1) * stride + c, s < kv_len);
  }
}

// The A fragment of a 16 x 16 block whose fp32 values are the C fragments
// c0 (columns 0-7) and c1 (columns 8-15), each value rounded once to bf16.
__device__ __forceinline__ void c_to_a(const float (&c0)[4], const float (&c1)[4],
                                       uint32_t (&a)[4]) {
  a[0] = tc::pack_bf16(c0[0], c0[1]);
  a[1] = tc::pack_bf16(c0[2], c0[3]);
  a[2] = tc::pack_bf16(c1[0], c1[1]);
  a[3] = tc::pack_bf16(c1[2], c1[3]);
}

template <int D>
__global__ void __launch_bounds__(TC_NT)
bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ g, const float* __restrict__ lse,
            const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
            int S, int Hq, int Hkv, int kv_len, float scale) {
  using C = TcConfig<D>;
  constexpr int LD = C::LD, CW = C::CW_KV, TILE = C::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);                 // [TB][LD]
  bf16* Vs = Ks + TILE;                                         // [TB][LD]
  bf16* Qs = Vs + TILE;                                         // [STAGES][TB][LD]
  bf16* Gs = Qs + STAGES * TILE;                                // [STAGES][TB][LD] dO
  float* Ls = reinterpret_cast<float*>(Gs + STAGES * TILE);     // [STAGES][TB] lse
  float* Dl = Ls + STAGES * TB;                                 // [STAGES][TB] D

  const int k0 = blockIdx.x * TB;  // the heaviest key tiles (k0 = 0) come first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int n_rep = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int wk0 = k0 + warp * 16;  // the warp's first key row
  const long q_stride = static_cast<long>(Hq) * D;
  const long kv_stride = static_cast<long>(Hkv) * D;
  const long kv_off = static_cast<long>(b) * S * kv_stride + static_cast<long>(hk) * D;

  // the walk: for each query head of the group, the query tiles from the
  // diagonal to kv_len (none when k0 >= kv_len)
  const int first = k0 / TB;
  const int per_head = max((kv_len + TB - 1) / TB - first, 0);
  const int n_iter = n_rep * per_head;
  const auto load = [&](int it, int st) {
    const int h = hk * n_rep + it / per_head;
    const int r0 = (first + it % per_head) * TB;
    const long q_off = static_cast<long>(b) * S * q_stride + static_cast<long>(h) * D;
    copy_tile<D>(Qs + st * TILE, q + q_off, q_stride, r0, kv_len);
    copy_tile<D>(Gs + st * TILE, g + q_off, q_stride, r0, kv_len);
    const int r = tid % TB, s = r0 + r;
    const float* src = (tid < TB ? lse : delta) + (static_cast<long>(b) * Hq + h) * S;
    tc::cp_async4(&(tid < TB ? Ls : Dl)[st * TB + r], src + min(s, kv_len - 1), s < kv_len);
  };
  if (n_iter > 0) {
    copy_tile<D>(Ks, k + kv_off, kv_stride, k0, kv_len);
    copy_tile<D>(Vs, v + kv_off, kv_stride, k0, kv_len);
    load(0, 0);
    tc::cp_async_commit();
  }

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  const int a_row = (warp * 16 + lane % 16) * LD + (lane / 16) * 8;  // A-fragment address
  const float scale2 = scale * tc::LOG2E;

  for (int it = 0; it < n_iter; ++it) {
    const int st = it % STAGES;
    tc::cp_async_wait<0>();
    __syncthreads();  // tile it (and K, V) landed for all; the stage tile it+1 reuses is free
    if (it + 1 < n_iter) {
      load(it + 1, (it + 1) % STAGES);
      tc::cp_async_commit();
    }
    const int q0 = (first + it % per_head) * TB;
    const bf16* Qt = Qs + st * TILE;
    const bf16* Gt = Gs + st * TILE;
    const float* Lt = Ls + st * TB;
    const float* Dt = Dl + st * TB;

#pragma unroll 1
    for (int c0 = 0; c0 < TB; c0 += CW) {
      const int qc0 = q0 + c0;  // the pass's first query column
      if (qc0 + CW <= wk0 || qc0 >= kv_len) continue;  // every pair masked for this warp

      // S^T = K Q^T and dP^T = V dO^T: the warp's 16 key rows x CW queries
      float sT[CW / 8][4], dpT[CW / 8][4];
#pragma unroll
      for (int n = 0; n < CW / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[n][e] = dpT[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];  // K and V stay in shared memory: registers go to occupancy
        tc::ldmatrix_x4(ka, &Ks[a_row + kk * 16]);
        tc::ldmatrix_x4(va, &Vs[a_row + kk * 16]);
#pragma unroll
        for (int n2 = 0; n2 < CW / 16; ++n2) {
          const int off = (c0 + n2 * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                          ((lane / 8) % 2) * 8;
          uint32_t r[4];
          tc::ldmatrix_x4(r, &Qt[off]);
          tc::mma_bf16(sT[2 * n2], ka, r[0], r[1]);
          tc::mma_bf16(sT[2 * n2 + 1], ka, r[2], r[3]);
          tc::ldmatrix_x4(r, &Gt[off]);
          tc::mma_bf16(dpT[2 * n2], va, r[0], r[1]);
          tc::mma_bf16(dpT[2 * n2 + 1], va, r[2], r[3]);
        }
      }

      // P^T and dS^T in place; lse and D are per query, so per column here
      const bool edge = qc0 < wk0 + 15 || qc0 + CW > kv_len;
#pragma unroll
      for (int n = 0; n < CW / 8; ++n) {
        const int col = c0 + n * 8 + 2 * t4;
        const float2 l2 = *reinterpret_cast<const float2*>(&Lt[col]);
        const float2 d2 = *reinterpret_cast<const float2*>(&Dt[col]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = tc::exp2_fast(sT[n][e] * scale2 - ((e & 1) ? l2.y : l2.x));
          if (edge) {
            const int qp = q0 + col + (e & 1), kp = wk0 + g8 + (e >> 1) * 8;
            p = (kp <= qp && qp < kv_len) ? p : 0.f;
          }
          sT[n][e] = p;
          dpT[n][e] = p * (dpT[n][e] - ((e & 1) ? d2.y : d2.x));
        }
      }

      // dV += P^T dO and dK += dS^T Q over the pass's queries
#pragma unroll
      for (int kc = 0; kc < CW / 16; ++kc) {
        uint32_t pa[4], sa[4];
        c_to_a(sT[2 * kc], sT[2 * kc + 1], pa);
        c_to_a(dpT[2 * kc], dpT[2 * kc + 1], sa);
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          const int off = (c0 + kc * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD + n2 * 16 +
                          (lane / 16) * 8;
          uint32_t r[4];
          tc::ldmatrix_x4_trans(r, &Gt[off]);
          tc::mma_bf16(acc_v[2 * n2], pa, r[0], r[1]);
          tc::mma_bf16(acc_v[2 * n2 + 1], pa, r[2], r[3]);
          tc::ldmatrix_x4_trans(r, &Qt[off]);
          tc::mma_bf16(acc_k[2 * n2], sa, r[0], r[1]);
          tc::mma_bf16(acc_k[2 * n2 + 1], sa, r[2], r[3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = wk0 + g8 + 8 * i;
    if (s >= S) continue;
    bf16* dkr = dk + kv_off + s * kv_stride;
    bf16* dvr = dv + kv_off + s * kv_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(&dkr[n * 8 + 2 * t4]) =
          tc::pack_bf16(acc_k[n][2 * i] * scale, acc_k[n][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(&dvr[n * 8 + 2 * t4]) =
          tc::pack_bf16(acc_v[n][2 * i], acc_v[n][2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(TC_NT)
bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ g, const float* __restrict__ lse,
          const float* __restrict__ delta, bf16* __restrict__ dq, int S, int Hq, int Hkv,
          int kv_len, float scale) {
  using C = TcConfig<D>;
  constexpr int LD = C::LD, CW = C::CW_Q, TILE = C::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [TB][LD]
  bf16* Gs = Qs + TILE;                          // [TB][LD] dO
  bf16* Ks = Gs + TILE;                          // [STAGES][TB][LD]
  bf16* Vs = Ks + STAGES * TILE;                 // [STAGES][TB][LD]

  const int qt = gridDim.x - 1 - blockIdx.x;  // the heaviest query tiles first
  const int q0 = qt * TB;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int wq0 = q0 + warp * 16;  // the warp's first query row
  const long q_stride = static_cast<long>(Hq) * D;
  const long kv_stride = static_cast<long>(Hkv) * D;
  const long q_off = static_cast<long>(b) * S * q_stride + static_cast<long>(h) * D;
  const long kv_off = static_cast<long>(b) * S * kv_stride + static_cast<long>(hk) * D;

  // keys up to the tile's last live row: none when q0 >= kv_len
  const int n_tiles = q0 < kv_len ? (min(q0 + TB, kv_len) + TB - 1) / TB : 0;
  const auto load_kv = [&](int kt, int st) {
    copy_tile<D>(Ks + st * TILE, k + kv_off, kv_stride, kt * TB, kv_len);
    copy_tile<D>(Vs + st * TILE, v + kv_off, kv_stride, kt * TB, kv_len);
  };
  if (n_tiles > 0) {
    copy_tile<D>(Qs, q + q_off, q_stride, q0, kv_len);
    copy_tile<D>(Gs, g + q_off, q_stride, q0, kv_len);
    load_kv(0, 0);
    tc::cp_async_commit();
  }

  // lse and D of this lane's two rows (wq0 + g8, + 8); 0 past kv_len
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = wq0 + g8 + 8 * i;
    const long row = (static_cast<long>(b) * Hq + h) * S + s;
    lr[i] = s < kv_len ? lse[row] : 0.f;
    dr[i] = s < kv_len ? delta[row] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qf[D / 16][4], gf[D / 16][4];
  const float scale2 = scale * tc::LOG2E;

  for (int kt = 0; kt < n_tiles; ++kt) {
    tc::cp_async_wait<0>();
    __syncthreads();  // tile kt (and Q, dO) landed for all; tile kt-1's stage is free
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8;
        tc::ldmatrix_x4(qf[kk], &Qs[off]);
        tc::ldmatrix_x4(gf[kk], &Gs[off]);
      }
    }
    if (kt + 1 < n_tiles) {
      load_kv(kt + 1, (kt + 1) % STAGES);
      tc::cp_async_commit();
    }
    const int k0 = kt * TB;
    const bf16* Kt = Ks + (kt % STAGES) * TILE;
    const bf16* Vt = Vs + (kt % STAGES) * TILE;

#pragma unroll 1
    for (int c0 = 0; c0 < TB; c0 += CW) {
      const int kc0 = k0 + c0;  // the pass's first key
      if (kc0 > wq0 + 15 || wq0 >= kv_len) continue;  // every pair masked for this warp

      // S = Q K^T and dP = dO V^T: the warp's 16 query rows x CW keys
      float s[CW / 8][4], dp[CW / 8][4];
#pragma unroll
      for (int n = 0; n < CW / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int n2 = 0; n2 < CW / 16; ++n2) {
          const int off = (c0 + n2 * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                          ((lane / 8) % 2) * 8;
          uint32_t r[4];
          tc::ldmatrix_x4(r, &Kt[off]);
          tc::mma_bf16(s[2 * n2], qf[kk], r[0], r[1]);
          tc::mma_bf16(s[2 * n2 + 1], qf[kk], r[2], r[3]);
          tc::ldmatrix_x4(r, &Vt[off]);
          tc::mma_bf16(dp[2 * n2], gf[kk], r[0], r[1]);
          tc::mma_bf16(dp[2 * n2 + 1], gf[kk], r[2], r[3]);
        }
      }

      // dS in place of S
      const bool edge = kc0 + CW - 1 > wq0 || wq0 + 16 > kv_len;
#pragma unroll
      for (int n = 0; n < CW / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float p = tc::exp2_fast(s[n][e] * scale2 - lr[i]);
          if (edge) {
            const int kp = kc0 + n * 8 + 2 * t4 + (e & 1), qp = wq0 + g8 + 8 * i;
            p = (kp <= qp && qp < kv_len) ? p : 0.f;
          }
          s[n][e] = p * (dp[n][e] - dr[i]);
        }

      // dQ += dS K, K by ldmatrix.trans from the same tile
#pragma unroll
      for (int kc = 0; kc < CW / 16; ++kc) {
        uint32_t sa[4];
        c_to_a(s[2 * kc], s[2 * kc + 1], sa);
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          uint32_t r[4];
          tc::ldmatrix_x4_trans(r, &Kt[(c0 + kc * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD +
                                       n2 * 16 + (lane / 16) * 8]);
          tc::mma_bf16(acc[2 * n2], sa, r[0], r[1]);
          tc::mma_bf16(acc[2 * n2 + 1], sa, r[2], r[3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = wq0 + g8 + 8 * i;
    if (s >= S) continue;
    bf16* dqr = dq + q_off + s * q_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(&dqr[n * 8 + 2 * t4]) =
          tc::pack_bf16(acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
}

template <int D>
cudaError_t launch_tc(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                      const bf16* o_lo, const bf16* g, const float* lse, float* delta, bf16* dq,
                      bf16* dk, bf16* dv, int B, int S, int Hq, int Hkv, int kv_len,
                      float scale, cudaStream_t st) {
  bwd_delta<bf16, D><<<dim3((S + NT / 32 - 1) / (NT / 32), Hq, B), NT, 0, st>>>(
      o, o_lo, g, delta, S, Hq, kv_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int tiles = (S + TB - 1) / TB;
  constexpr int smem_kv = TcConfig<D>::DKDV_SMEM;
  err = cudaFuncSetAttribute(bwd_dkdv_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return err;
  bwd_dkdv_tc<D><<<dim3(tiles, Hkv, B), TC_NT, smem_kv, st>>>(q, k, v, g, lse, delta, dk, dv,
                                                             S, Hq, Hkv, kv_len, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int smem_q = TcConfig<D>::DQ_SMEM;
  err = cudaFuncSetAttribute(bwd_dq_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return err;
  bwd_dq_tc<D><<<dim3(tiles, Hq, B), TC_NT, smem_q, st>>>(q, k, v, g, lse, delta, dq, S, Hq,
                                                         Hkv, kv_len, scale);
  return cudaGetLastError();
}

}  // namespace

// Causal only. dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores; q,
// k, v, o, o_lo, g 16-byte aligned). q, k, v, o, g and the grads share the
// dtype. o_lo: kernel A's bf16 rounding residual of O (bf16, required), null
// for fp32. lse: kernel A's base-2 log-sum-exp, fp32 [B, Hq, S]; delta:
// scratch fp32 [B, Hq, S]. Three launches on `stream` (D, then dK/dV, then
// dQ); returns cudaGetLastError() after the last, or the first error.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* o_lo, const void* g,
                                   const void* lse, void* delta, void* dq, void* dk, void* dv,
                                   int B, int S, int Hq, int Hkv, int D, int kv_len,
                                   float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (Hkv <= 0 || Hq % Hkv != 0 || kv_len < 1 || kv_len > S) return cudaErrorInvalidValue;
  if ((dtype == 1) != (o_lo != nullptr)) return cudaErrorInvalidValue;
  using F = const float*;
  using H = const bf16*;
  if (dtype == 0 && D == 64)
    return launch_f32<64>(F(q), F(k), F(v), F(o), F(g), l, dl, static_cast<float*>(dq),
                          static_cast<float*>(dk), static_cast<float*>(dv), B, S, Hq, Hkv,
                          kv_len, scale, st);
  if (dtype == 0 && D == 128)
    return launch_f32<128>(F(q), F(k), F(v), F(o), F(g), l, dl, static_cast<float*>(dq),
                           static_cast<float*>(dk), static_cast<float*>(dv), B, S, Hq, Hkv,
                           kv_len, scale, st);
  if (dtype == 1 && D == 64)
    return launch_tc<64>(H(q), H(k), H(v), H(o), H(o_lo), H(g), l, dl, static_cast<bf16*>(dq),
                         static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, S, Hq, Hkv, kv_len,
                         scale, st);
  if (dtype == 1 && D == 128)
    return launch_tc<128>(H(q), H(k), H(v), H(o), H(o_lo), H(g), l, dl, static_cast<bf16*>(dq),
                          static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, S, Hq, Hkv,
                          kv_len, scale, st);
  return cudaErrorInvalidValue;
}
