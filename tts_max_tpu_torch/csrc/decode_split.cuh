// One-token decode attention, the parts that kernel B (flash_decode.cu, a
// contiguous cache), kernel C (ragged_decode.cu, the same cache) and the
// paged kernel (paged_decode.cu, a block pool read through a block table)
// share: where row t of sequence b lives (ContiguousRows, PagedRows), the
// launch-time argument checks, the merge of a block's warp states, the
// combine of the splits, and the CUDA-core split-K kernel that serves fp32
// queries. bf16 queries run on the tensor cores (decode_tc.cuh).
//
// What it computes: out[b, h] = softmax_t(q[b, h] . K[b, t, h/n_rep] *
// D^-1/2 over t < lengths[b]) @ V[b, t, h/n_rep]. The cache is fp32 (in
// q's dtype) or int8 with fp32 scales per (row, head), dequantized in
// registers: the K scale multiplies the score, the V scale the probability,
// as the Pallas kernels fold them.
//
// Grid (split, kv head, batch): each block of NW warps takes one slice of
// rows (split-K), so that few sequences still spread over every SM. In
// split_kernel a warp holds the n_rep query rows of its kv head in
// registers (D/32 elements a lane), loads U K and U V rows ahead, reduces
// each score across the warp with shuffles and keeps a running max, sum and
// accumulator per query row (online softmax in fp32). Rows at or past
// lengths[b] are never loaded, so whatever they hold (garbage, NaN) cannot
// reach the result. The warps of a block merge their states through shared
// memory (merge_warps) and write one partial (max, sum, accumulator) per
// query row; combine_kernel merges the splits and writes the output in q's
// dtype. With no row in any split (a length of 0) every partial is (-1e30,
// 0, 0), each weight exp(0) = 1, and the output 0 / 1e-30 = 0 exactly.
#pragma once

#include "common.cuh"

namespace ttsk {
namespace decode {

constexpr int NW = 4;       // warps per block
constexpr int U = 4;        // rows a split_kernel warp loads ahead
constexpr int MAX_REP = 8;  // query heads per kv head
constexpr int C = 32;       // rows per tensor-core chunk

// Row policies. A split starts at row t_begin of its sequence and is
// walked (by the tensor-core kernels) in chunks of at most C rows; the
// policy says where chunk c starts, what must be read to find it
// (lookup: a block id, or nothing), the index of (row t of sequence b,
// head hk) in units of one head's row, and how many of the chunk's C rows
// are valid. The valid rows are always the chunk's first ones.

// Cache [B, T, Hkv, D] (scales [B, T, Hkv]); a split is whole chunks of C
// consecutive rows.
struct ContiguousRows {
  int T, Hkv;
  __device__ __forceinline__ int cap() const { return T; }
  __device__ __forceinline__ int chunks(int rows) const { return (rows + C - 1) / C; }
  __device__ __forceinline__ int chunk_start(int c) const { return c * C; }
  __device__ __forceinline__ int lookup(int, int) const { return 0; }
  __device__ __forceinline__ long row(int b, int t, int hk, int) const {
    return (static_cast<long>(b) * T + t) * Hkv + hk;
  }
  __device__ __forceinline__ int valid(int t, int len) const { return min(C, len - t); }
  __device__ __forceinline__ long index(int b, int t, int hk) const { return row(b, t, hk, 0); }
};

// Pool [N, bs, Hkv, D] (scales [N, bs, Hkv]) read through table [B, P]:
// row t of sequence b is row t % bs of block table[b, t / bs]. Block ids
// are clamped into the pool, as XLA clamps a gather index. A split is
// whole pages; a chunk never crosses a page, so with bs < C (or bs not a
// multiple of C) the rows of a chunk past its page's end are masked.
struct PagedRows {
  const int* table;
  int P, bs, N, Hkv;
  __device__ __forceinline__ int cap() const { return P * bs; }
  __device__ __forceinline__ int per_page() const { return (bs + C - 1) / C; }
  __device__ __forceinline__ int chunks(int rows) const {
    return rows / bs * per_page() + (rows % bs + C - 1) / C;
  }
  __device__ __forceinline__ int chunk_start(int c) const {
    return c / per_page() * bs + c % per_page() * C;
  }
  __device__ __forceinline__ int lookup(int b, int t) const {
    return min(max(table[static_cast<long>(b) * P + t / bs], 0), N - 1);
  }
  __device__ __forceinline__ long row(int, int t, int hk, int blk) const {
    return (static_cast<long>(blk) * bs + t % bs) * Hkv + hk;
  }
  __device__ __forceinline__ int valid(int t, int len) const {
    return min(min(C, bs - t % bs), len - t);
  }
  __device__ __forceinline__ long index(int b, int t, int hk) const {
    return row(b, t, hk, lookup(b, t));
  }
};

// Shared memory of merge_warps: m and l [NW][MAX_REP], acc [NW][MAX_REP][D].
template <int D>
__host__ __device__ constexpr int merge_bytes() {
  return NW * MAX_REP * (2 + D) * 4;
}

// The warps of a block have each stored their (m, l, acc) of query row r
// at sm_m[w][r], sm_l[w][r], sm_acc[w][r][:] of sm (layout above); this
// waits for all of them, merges the NW states of each row and writes the
// block's partial: part_acc [B, Hkv, n_split, n_rep, D], part_ml [..., 2].
template <int D>
__device__ __forceinline__ void merge_warps(const float* sm, int n_rep, long part0,
                                            float* __restrict__ part_acc,
                                            float* __restrict__ part_ml) {
  const float* sm_m = sm;
  const float* sm_l = sm + NW * MAX_REP;
  const float* sm_acc = sm + 2 * NW * MAX_REP;
  __syncthreads();
  for (int i = threadIdx.x; i < n_rep * D; i += NW * 32) {
    const int r = i / D, d = i % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w * MAX_REP + r]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(sm_m[w * MAX_REP + r] - mx);
      sum += sm_l[w * MAX_REP + r] * f;
      a += sm_acc[(w * MAX_REP + r) * D + d] * f;
    }
    const long pi = part0 + r;
    part_acc[pi * D + d] = a;
    if (d == 0) {
      part_ml[pi * 2] = mx;
      part_ml[pi * 2 + 1] = sum;
    }
  }
}

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

// fp32 queries over an fp32 or int8 cache, on the CUDA cores.
template <typename TC, int D, typename Rows>
__global__ void __launch_bounds__(NW * 32)
split_kernel(const float* __restrict__ q, const TC* __restrict__ kc,
             const TC* __restrict__ vc, const float* __restrict__ kscale,
             const float* __restrict__ vscale, const int* __restrict__ lengths,
             float* __restrict__ part_acc, float* __restrict__ part_ml, Rows rows,
             int Hq, int Hkv, int n_split, int rows_per_split, float scale) {
  constexpr int EPL = D / 32;  // elements of a row per lane
  __shared__ float sm[merge_bytes<D>() / 4];

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
        qr[r][e] = q[qi] * scale;
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
      sm[warp * MAX_REP + r] = m[r];
      sm[(NW + warp) * MAX_REP + r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      sm[2 * NW * MAX_REP + (warp * MAX_REP + r) * D + lane * EPL + e] = acc[r][e];
  }
  merge_warps<D>(sm, n_rep, ((static_cast<long>(b) * Hkv + hk) * n_split + split) * n_rep,
                 part_acc, part_ml);
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
// allocates; ks/vs are null unless the cache is int8. q_dtype: 0 float32,
// 1 bfloat16; quant: the cache is int8 with scales, else in q's dtype.
struct Args {
  const void *q, *k, *v, *ks, *vs, *lengths;
  void *part_acc, *part_ml, *out;
  int B, Hq, Hkv, D, n_split, rows_per_split;
  float scale;
  int q_dtype, quant;
  cudaStream_t stream;
};

inline bool aligned(const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

// The launch-time checks of every entry point: the head counts, the split,
// the scales of an int8 cache, and for bf16 queries (the tensor cores,
// which copy 16-byte pieces of each row and read q and the scales in 4-byte
// words) the alignment of the caches, q and the scales. rows_per_split is
// a multiple of `unit` (C for the tensor cores' contiguous walk, the block
// size for a paged one) and the splits cover `rows` rows.
inline cudaError_t check_args(const Args& a, long rows, int unit) {
  if (a.B < 1 || a.Hkv < 1 || a.Hq % a.Hkv != 0 || a.Hq / a.Hkv > MAX_REP || a.n_split < 1 ||
      a.rows_per_split < 1 || unit < 1 || a.rows_per_split % unit != 0 ||
      static_cast<long>(a.n_split) * a.rows_per_split < rows || (a.D != 64 && a.D != 128) ||
      (a.q_dtype != 0 && a.q_dtype != 1) || (a.quant && (!a.ks || !a.vs)))
    return cudaErrorInvalidValue;
  if (a.q_dtype == 1 && (!aligned(a.k, 16) || !aligned(a.v, 16) || !aligned(a.q, 4) ||
                         (a.quant && (!aligned(a.ks, 4) || !aligned(a.vs, 4)))))
    return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

template <typename TQ, int D>
cudaError_t launch_combine(const Args& a) {
  combine_kernel<TQ, D><<<dim3(a.Hkv, a.B), 256, 0, a.stream>>>(
      static_cast<const float*>(a.part_acc), static_cast<const float*>(a.part_ml),
      static_cast<TQ*>(a.out), a.Hq, a.Hkv, a.n_split);
  return cudaGetLastError();
}

template <typename TC, int D, typename Rows>
cudaError_t launch_split(const Args& a, Rows rows) {
  split_kernel<TC, D, Rows><<<dim3(a.n_split, a.Hkv, a.B), NW * 32, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const TC*>(a.k), static_cast<const TC*>(a.v),
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int*>(a.lengths), static_cast<float*>(a.part_acc),
      static_cast<float*>(a.part_ml), rows, a.Hq, a.Hkv, a.n_split, a.rows_per_split,
      a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine<float, D>(a);
}

// fp32 queries over an fp32 (quant 0) or int8 (quant 1) cache.
template <typename Rows>
cudaError_t run_split(const Args& a, Rows rows) {
  if (a.q_dtype != 0) return cudaErrorInvalidValue;
  if (a.D == 64) return a.quant ? launch_split<int8_t, 64>(a, rows)
                                : launch_split<float, 64>(a, rows);
  if (a.D == 128) return a.quant ? launch_split<int8_t, 128>(a, rows)
                                 : launch_split<float, 128>(a, rows);
  return cudaErrorInvalidValue;
}

}  // namespace decode
}  // namespace ttsk
