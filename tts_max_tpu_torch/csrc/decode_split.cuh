// Split-K one-token decode attention, shared by kernel B (flash_decode.cu,
// a contiguous cache) and the paged kernel (paged_decode.cu, a block pool
// read through a block table). The two differ only in where cache row t of
// sequence b lives, which a row-addressing policy (ContiguousRows,
// PagedRows) supplies.
//
// What it computes: out[b, h] = softmax_t(q[b, h] . K[b, t, h/n_rep] *
// D^-1/2 over t < lengths[b]) @ V[b, t, h/n_rep]. The cache is bf16 or fp32
// in q's dtype, or int8 with fp32 scales per (row, head), dequantized in
// registers: the K scale multiplies the score, the V scale the probability,
// as the Pallas kernels fold them.
//
// Grid (split, kv head, batch): each block of NW warps takes one slice of
// rows (split-K), so that few sequences still spread over every SM. A warp
// holds the n_rep query rows of its kv head in registers (D/32 elements a
// lane), loads U K and U V rows ahead, reduces each score across the warp
// with shuffles and keeps a running max, sum and accumulator per query row
// (online softmax in fp32). Rows at or past lengths[b] are never loaded, so
// whatever they hold (garbage, NaN) cannot reach the result. The warps of a
// block merge their states through shared memory and write one partial
// (max, sum, accumulator) per query row; combine_kernel merges the splits
// and writes the output in q's dtype.
#pragma once

#include "common.cuh"

namespace ttsk {
namespace decode {

constexpr int NW = 4;       // warps per block
constexpr int U = 4;        // rows a warp loads ahead
constexpr int MAX_REP = 8;  // query heads per kv head

// Cache [B, T, Hkv, D] (scales [B, T, Hkv]).
struct ContiguousRows {
  int T, Hkv;
  __device__ __forceinline__ int cap() const { return T; }
  // index of (row t of sequence b, head hk) in units of one head's row
  __device__ __forceinline__ long index(int b, int t, int hk) const {
    return (static_cast<long>(b) * T + t) * Hkv + hk;
  }
};

// Pool [N, bs, Hkv, D] (scales [N, bs, Hkv]) read through table [B, P]:
// row t of sequence b is row t % bs of block table[b, t / bs]. Block ids
// are clamped into the pool, as XLA clamps a gather index.
struct PagedRows {
  const int* table;
  int P, bs, N, Hkv;
  __device__ __forceinline__ int cap() const { return P * bs; }
  __device__ __forceinline__ long index(int b, int t, int hk) const {
    const int blk = min(max(table[static_cast<long>(b) * P + t / bs], 0), N - 1);
    return (static_cast<long>(blk) * bs + t % bs) * Hkv + hk;
  }
};

template <typename TC, int EPL>
__device__ __forceinline__ void load_row(const TC* p, float* out) {
#pragma unroll
  for (int e = 0; e < EPL; ++e) out[e] = to_float(p[e]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename TQ, typename TC, int D, typename Rows>
__global__ void __launch_bounds__(NW * 32)
split_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
             const TC* __restrict__ vc, const float* __restrict__ kscale,
             const float* __restrict__ vscale, const int* __restrict__ lengths,
             float* __restrict__ part_acc, float* __restrict__ part_ml, Rows rows,
             int Hq, int Hkv, int n_split, int rows_per_split, float scale) {
  constexpr int EPL = D / 32;  // elements of a row per lane
  __shared__ float sm_m[NW][MAX_REP];
  __shared__ float sm_l[NW][MAX_REP];
  __shared__ float sm_acc[NW][MAX_REP][D];

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_rep = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = min(lengths[b], rows.cap());
  const int t0 = split * rows_per_split;
  const int t1 = min(t0 + rows_per_split, len);

  float qr[MAX_REP][EPL], m[MAX_REP], l[MAX_REP], acc[MAX_REP][EPL];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[r][e] = 0.f;
      qr[r][e] = 0.f;
      if (r < n_rep) {
        const long qi = (static_cast<long>(b) * Hq + hk * n_rep + r) * D + lane * EPL + e;
        qr[r][e] = round_to(to_float(q[qi]) * scale, static_cast<TQ*>(nullptr));
      }
    }
  }

  for (int t = t0 + warp * U; t < t1; t += NW * U) {
    float kv[U][EPL], vv[U][EPL], ks[U], vs[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ks[u] = vs[u] = 1.f;
      if (t + u < t1) {
        const long ri = rows.index(b, t + u, hk);
        load_row<TC, EPL>(kc + ri * D + lane * EPL, kv[u]);
        load_row<TC, EPL>(vc + ri * D + lane * EPL, vv[u]);
        if (kscale != nullptr) {
          ks[u] = kscale[ri];
          vs[u] = vscale[ri];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t + u >= t1) break;  // warp-uniform
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (r >= n_rep) break;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qr[r][e], kv[u][e], dot);
        const float s = warp_sum(dot) * ks[u];
        const float m_new = fmaxf(m[r], s);
        const float alpha = expf(m[r] - m_new);
        const float p = expf(s - m_new);
        l[r] = alpha * l[r] + p;
        const float pv = p * vs[u];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(pv, vv[u][e], alpha * acc[r][e]);
        m[r] = m_new;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    if (r >= n_rep) break;
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][r][lane * EPL + e] = acc[r][e];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_rep * D; i += NW * 32) {
    const int r = i / D, d = i % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(sm_m[w][r] - mx);
      sum += sm_l[w][r] * f;
      a += sm_acc[w][r][d] * f;
    }
    const long pi = ((static_cast<long>(b) * Hkv + hk) * n_split + split) * n_rep + r;
    part_acc[pi * D + d] = a;
    if (d == 0) {
      part_ml[pi * 2] = mx;
      part_ml[pi * 2 + 1] = sum;
    }
  }
}

template <typename TQ, int D>
__global__ void __launch_bounds__(256)
combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
               TQ* __restrict__ out, int Hq, int Hkv, int n_split) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const int n_rep = Hq / Hkv;
  for (int i = threadIdx.x; i < n_rep * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const long p0 = (static_cast<long>(b) * Hkv + hk) * n_split * n_rep + r;
    float mx = NEG_INF;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, part_ml[(p0 + s * n_rep) * 2]);
    float sum = 0.f, a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const long pi = p0 + s * n_rep;
      const float f = expf(part_ml[pi * 2] - mx);
      sum += part_ml[pi * 2 + 1] * f;
      a += part_acc[pi * D + d] * f;
    }
    store(&out[(static_cast<long>(b) * Hq + hk * n_rep + r) * D + d], a / fmaxf(sum, 1e-30f));
  }
}

// The arguments every launch shares. part_acc [B, Hkv, n_split, n_rep, D]
// and part_ml [B, Hkv, n_split, n_rep, 2] are fp32 scratch the caller
// allocates; ks/vs are null unless the cache is int8.
struct Args {
  const void *q, *k, *v, *ks, *vs, *lengths;
  void *part_acc, *part_ml, *out;
  int B, Hq, Hkv, n_split, rows_per_split;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TC, int D, typename Rows>
cudaError_t launch(const Args& a, Rows rows) {
  split_kernel<TQ, TC, D, Rows><<<dim3(a.n_split, a.Hkv, a.B), NW * 32, 0, a.stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TC*>(a.k), static_cast<const TC*>(a.v),
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int*>(a.lengths), static_cast<float*>(a.part_acc),
      static_cast<float*>(a.part_ml), rows, a.Hq, a.Hkv, a.n_split, a.rows_per_split,
      a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<TQ, D><<<dim3(a.Hkv, a.B), 256, 0, a.stream>>>(
      static_cast<const float*>(a.part_acc), static_cast<const float*>(a.part_ml),
      static_cast<TQ*>(a.out), a.Hq, a.Hkv, a.n_split);
  return cudaGetLastError();
}

template <typename TQ, typename TC, typename Rows>
cudaError_t launch_d(int D, const Args& a, Rows rows) {
  if (D == 64) return launch<TQ, TC, 64>(a, rows);
  if (D == 128) return launch<TQ, TC, 128>(a, rows);
  return cudaErrorInvalidValue;
}

// q_dtype: 0 float32, 1 bfloat16; quant: the cache is int8 with scales
// (a.ks, a.vs), else it is in q's dtype.
template <typename Rows>
cudaError_t run(int D, int q_dtype, int quant, const Args& a, Rows rows) {
  if (a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.Hq / a.Hkv > MAX_REP || a.n_split < 1 ||
      a.rows_per_split < 1 || (quant && (!a.ks || !a.vs)))
    return cudaErrorInvalidValue;
  if (q_dtype == 0 && !quant) return launch_d<float, float>(D, a, rows);
  if (q_dtype == 1 && !quant) return launch_d<__nv_bfloat16, __nv_bfloat16>(D, a, rows);
  if (q_dtype == 0 && quant) return launch_d<float, int8_t>(D, a, rows);
  if (q_dtype == 1 && quant) return launch_d<__nv_bfloat16, int8_t>(D, a, rows);
  return cudaErrorInvalidValue;
}

}  // namespace decode
}  // namespace ttsk
