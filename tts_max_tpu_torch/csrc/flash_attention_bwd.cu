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
//   dV_j = sum_i P_ij dO_i,  dK_j = D^-1/2 sum_i dS_ij q_i   (bwd_dkdv)
//   dQ_i = D^-1/2 sum_j dS_ij k_j                            (bwd_dq)
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
// products (S, dP, dV, dK, dQ: 5 * B * Hq * S^2 * D / 2 multiply-adds, 2.7x
// the forward's) against ~5 * S * H * D * 2 bytes of input.
//
// This first design is simple and deterministic, not fast: no atomics, every
// output element written once by one thread, all arithmetic in fp32 on the
// CUDA cores for both dtypes (bf16 P or dS on the tensor cores would err by
// up to 2^-8 relative; the fast design, with the hi/lo split kernel A uses
// for P, is a later change). Two blocks kinds, FlashAttention-2's split:
//   bwd_dkdv: one block per (key tile of 64 rows, kv head, batch) holds its K
//     and V tiles in shared memory and dK, dV in registers; it walks the
//     group's query heads and, for each, the query tiles from the diagonal
//     to kv_len (the causal trip count), recomputing P and dS tile by tile.
//     It recomputes S and dP (4 products a tile pair).
//   bwd_dq: one block per (query tile, query head, batch) holds Q, dO, lse and
//     D, walks the key tiles up to the diagonal and keeps dQ in registers
//     (3 products a tile pair).
// Each block runs 256 threads as a 16 x 16 grid; a thread owns a 4 x 4 (or
// 4 x 8 at D = 128) register micro-tile of each product, as kernel A's fp32
// path does. Shared rows are padded by one float against bank conflicts.
#include "common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // key rows per tile
constexpr int NT = 256;  // a 16 x 16 thread grid
constexpr int RM = 4;    // micro-tile rows per thread (64 / 16)
constexpr float LOG2E = 1.4426950408889634f;

// D_i = sum_d dO_id O_id for rows < kv_len (0 past it): one warp per row.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_delta(const T* __restrict__ o, const T* __restrict__ g, float* __restrict__ delta,
          int S, int Hq, int kv_len) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (NT / 32) + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= S) return;
  float acc = 0.f;
  if (row < kv_len) {
    const long base = (static_cast<long>(b) * S + row) * Hq * D + static_cast<long>(h) * D;
#pragma unroll
    for (int d = lane; d < D; d += 32)
      acc += ttsk::to_float(o[base + d]) * ttsk::to_float(g[base + d]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) delta[(static_cast<long>(b) * Hq + h) * S + row] = acc;
}

// Rows [r0, r0 + 64) of the [S, H, D] tensor x at head h into shared fp32
// [64][D + 1], zero past row `end`.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ x, long stride,
                                          int r0, int end) {
  for (int i = threadIdx.x; i < 64 * D; i += NT) {
    const int r = i / D, c = i % D, s = r0 + r;
    dst[r * (D + 1) + c] = s < end ? ttsk::to_float(x[s * stride + c]) : 0.f;
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

template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ g, const float* __restrict__ lse,
         const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int S,
         int Hq, int Hkv, int kv_len, float scale) {
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

  load_tile<T, D>(Ks, k + kv_off, kv_stride, k0, kv_len);
  load_tile<T, D>(Vs, v + kv_off, kv_stride, k0, kv_len);

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
      load_tile<T, D>(Qs, q + q_off, q_stride, q0, kv_len);
      load_tile<T, D>(Gs, g + q_off, q_stride, q0, kv_len);
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
      ttsk::store(&dk[idx], acc_k[i][c] * scale);
      ttsk::store(&dv[idx], acc_v[i][c]);
    }
  }
}

template <int D>
constexpr int dq_smem_floats() {
  return 4 * 64 * (D + 1) + BQ * (BK + 1) + 2 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       const T* __restrict__ g, const float* __restrict__ lse,
       const float* __restrict__ delta, T* __restrict__ dq, int S, int Hq, int Hkv,
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

  load_tile<T, D>(Qs, q + q_off, q_stride, q0, kv_len);
  load_tile<T, D>(Gs, g + q_off, q_stride, q0, kv_len);
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
    load_tile<T, D>(Ks, k + kv_off, kv_stride, k0, kv_len);
    load_tile<T, D>(Vs, v + kv_off, kv_stride, k0, kv_len);
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
    for (int c = 0; c < CN; ++c)
      ttsk::store(&dq[q_off + s * q_stride + tx + 16 * c], acc[i][c] * scale);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* g,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S,
                   int Hq, int Hkv, int kv_len, float scale, cudaStream_t st) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* g_ = static_cast<const T*>(g);
  bwd_delta<T, D><<<dim3((S + NT / 32 - 1) / (NT / 32), Hq, B), NT, 0, st>>>(
      static_cast<const T*>(o), g_, delta, S, Hq, kv_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int tiles = (S + 63) / 64;
  const int smem_kv = dkdv_smem_floats<D>() * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(bwd_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return err;
  bwd_dkdv<T, D><<<dim3(tiles, Hkv, B), NT, smem_kv, st>>>(
      q_, k_, v_, g_, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, Hq, Hkv,
      kv_len, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_q = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(bwd_dq<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  bwd_dq<T, D><<<dim3(tiles, Hq, B), NT, smem_q, st>>>(
      q_, k_, v_, g_, lse, delta, static_cast<T*>(dq), S, Hq, Hkv, kv_len, scale);
  return cudaGetLastError();
}

}  // namespace

// Causal only. dtype: 0 float32, 1 bfloat16 (q, k, v, o, g and the grads
// share it). lse: kernel A's base-2 log-sum-exp, fp32 [B, Hq, S]; delta:
// scratch fp32 [B, Hq, S]. Three launches on `stream` (D, then dK/dV, then
// dQ); returns cudaGetLastError() after the last, or the first error.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* g, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv, int B, int S,
                                   int Hq, int Hkv, int D, int kv_len, float scale,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (Hkv <= 0 || Hq % Hkv != 0 || kv_len < 1 || kv_len > S) return cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, g, l, dl, dq, dk, dv, B, S, Hq, Hkv, kv_len, scale,
                             st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, g, l, dl, dq, dk, dv, B, S, Hq, Hkv, kv_len, scale,
                              st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, g, l, dl, dq, dk, dv, B, S, Hq, Hkv, kv_len,
                                     scale, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, g, l, dl, dq, dk, dv, B, S, Hq, Hkv,
                                      kv_len, scale, st);
  return cudaErrorInvalidValue;
}
