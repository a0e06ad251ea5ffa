// Kernel B: flash decode attention, one new token per sequence against a
// contiguous KV cache.
//
// Replaces: tts_max_tpu/ops/pallas_decode.py, flash_decode_attention (the
// Pallas kernel of its pallas_call, contiguous [B, T, Hkv, D] form; the port
// passes cache[layer], a contiguous view, in place of the stacked form).
//
// What it computes: out[b, h] = softmax_t(q[b, h] . K[b, t, h/n_rep] *
// D^-1/2 over t < lengths[b]) @ V[b, :, h/n_rep]. The cache is bf16 or fp32
// in q's dtype, or int8 with fp32 scales [B, T, Hkv] per (token, head),
// dequantized in registers: the K scale multiplies the score, the V scale
// the probability, as the Pallas kernel folds them.
//
// What bounds it on the H100: bytes. Each live cache row is read once and
// used for n_rep (4 at Llama-3.2-1B) multiply-adds per element, far below
// the card's ~295 operations per byte: the bound is 2 * len * Hkv * D *
// sizeof(cache) bytes over 3.35 TB/s (2.1 MB, 0.63 us at len=1024 in bf16).
//
// What the design does about it: it reads only rows < lengths[b] (a dynamic
// trip count costs nothing here; rows beyond the length, garbage or NaN,
// are never loaded), and spreads those rows over enough blocks to keep many
// loads in flight. Grid (split, kv head, batch): each block of 4 warps
// takes one slice of rows (split-K), so that a batch of one, with only 8 kv
// heads, still runs on every SM. A warp holds the n_rep query rows of its kv
// head in registers (D/32 elements a lane), loads 4 K and 4 V rows ahead,
// reduces each score across the warp with shuffles and keeps a running
// max, sum and accumulator per query row (online softmax in fp32). The
// warps of a block merge their states through shared memory and write one
// partial (max, sum, accumulator) per query row; a second small kernel
// merges the splits and writes the output in q's dtype.
#include "common.cuh"

namespace {

constexpr int NW = 4;       // warps per block
constexpr int U = 4;        // rows a warp loads ahead
constexpr int MAX_REP = 8;  // query heads per kv head

template <typename TC, int EPL>
__device__ __forceinline__ void load_row(const TC* p, float* out) {
#pragma unroll
  for (int e = 0; e < EPL; ++e) out[e] = ttsk::to_float(p[e]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename TQ, typename TC, int D>
__global__ void __launch_bounds__(NW * 32)
decode_split_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                    const TC* __restrict__ vc, const float* __restrict__ kscale,
                    const float* __restrict__ vscale, const int* __restrict__ lengths,
                    float* __restrict__ part_acc, float* __restrict__ part_ml, int T,
                    int Hq, int Hkv, int n_split, int rows_per_split, float scale) {
  constexpr int EPL = D / 32;  // elements of a row per lane
  __shared__ float sm_m[NW][MAX_REP];
  __shared__ float sm_l[NW][MAX_REP];
  __shared__ float sm_acc[NW][MAX_REP][D];

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_rep = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = min(lengths[b], T);
  const int t0 = split * rows_per_split;
  const int t1 = min(t0 + rows_per_split, len);

  float qr[MAX_REP][EPL], m[MAX_REP], l[MAX_REP], acc[MAX_REP][EPL];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    m[r] = ttsk::NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[r][e] = 0.f;
      qr[r][e] = 0.f;
      if (r < n_rep) {
        const long qi = (static_cast<long>(b) * Hq + hk * n_rep + r) * D + lane * EPL + e;
        qr[r][e] = ttsk::round_to(ttsk::to_float(q[qi]) * scale, static_cast<TQ*>(nullptr));
      }
    }
  }

  const long row_stride = static_cast<long>(Hkv) * D;
  const long head_off = static_cast<long>(b) * T * Hkv + hk;  // (b, t=0, hk)
  const TC* kb = kc + head_off * D + lane * EPL;
  const TC* vb = vc + head_off * D + lane * EPL;

  for (int t = t0 + warp * U; t < t1; t += NW * U) {
    float kv[U][EPL], vv[U][EPL], ks[U], vs[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ks[u] = vs[u] = 1.f;
      if (t + u < t1) {
        load_row<TC, EPL>(kb + (t + u) * row_stride, kv[u]);
        load_row<TC, EPL>(vb + (t + u) * row_stride, vv[u]);
        if (kscale != nullptr) {
          ks[u] = kscale[head_off + static_cast<long>(t + u) * Hkv];
          vs[u] = vscale[head_off + static_cast<long>(t + u) * Hkv];
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
    float mx = ttsk::NEG_INF;
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
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml, TQ* __restrict__ out,
                      int Hq, int Hkv, int n_split) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const int n_rep = Hq / Hkv;
  for (int i = threadIdx.x; i < n_rep * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const long p0 = (static_cast<long>(b) * Hkv + hk) * n_split * n_rep + r;
    float mx = ttsk::NEG_INF;
    for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, part_ml[(p0 + s * n_rep) * 2]);
    float sum = 0.f, a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const long pi = p0 + s * n_rep;
      const float f = expf(part_ml[pi * 2] - mx);
      sum += part_ml[pi * 2 + 1] * f;
      a += part_acc[pi * D + d] * f;
    }
    ttsk::store(&out[(static_cast<long>(b) * Hq + hk * n_rep + r) * D + d],
                a / fmaxf(sum, 1e-30f));
  }
}

template <typename TQ, typename TC, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const void* lengths, void* part_acc,
                   void* part_ml, void* out, int B, int T, int Hq, int Hkv,
                   int n_split, int rows_per_split, float scale, cudaStream_t st) {
  decode_split_kernel<TQ, TC, D><<<dim3(n_split, Hkv, B), NW * 32, 0, st>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k), static_cast<const TC*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(lengths), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), T, Hq, Hkv, n_split, rows_per_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<TQ, D><<<dim3(Hkv, B), 256, 0, st>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<TQ*>(out), Hq, Hkv, n_split);
  return cudaGetLastError();
}

template <typename TQ, typename TC>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const void* ks, const void* vs, const void* lengths,
                     void* part_acc, void* part_ml, void* out, int B, int T, int Hq,
                     int Hkv, int n_split, int rows_per_split, float scale,
                     cudaStream_t st) {
  if (D == 64)
    return launch<TQ, TC, 64>(q, k, v, ks, vs, lengths, part_acc, part_ml, out, B, T,
                              Hq, Hkv, n_split, rows_per_split, scale, st);
  if (D == 128)
    return launch<TQ, TC, 128>(q, k, v, ks, vs, lengths, part_acc, part_ml, out, B, T,
                               Hq, Hkv, n_split, rows_per_split, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q_dtype: 0 float32, 1 bfloat16; quant: the cache is int8 with scales (ks,
// vs), else it is in q's dtype. part_acc [B, Hkv, n_split, n_rep, D] and
// part_ml [B, Hkv, n_split, n_rep, 2] are fp32 scratch the caller allocates.
// Returns cudaGetLastError() after the launches.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs, const void* lengths,
                                void* part_acc, void* part_ml, void* out, int B,
                                int T, int Hq, int Hkv, int D, int n_split,
                                int rows_per_split, float scale, int q_dtype,
                                int quant, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > MAX_REP || n_split < 1 ||
      static_cast<long>(n_split) * rows_per_split < T || (quant && (!ks || !vs)))
    return cudaErrorInvalidValue;
  if (q_dtype == 0 && !quant)
    return launch_d<float, float>(D, q, k, v, ks, vs, lengths, part_acc, part_ml, out,
                                  B, T, Hq, Hkv, n_split, rows_per_split, scale, st);
  if (q_dtype == 1 && !quant)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(D, q, k, v, ks, vs, lengths, part_acc,
                                                  part_ml, out, B, T, Hq, Hkv, n_split,
                                                  rows_per_split, scale, st);
  if (q_dtype == 0 && quant)
    return launch_d<float, int8_t>(D, q, k, v, ks, vs, lengths, part_acc, part_ml, out,
                                   B, T, Hq, Hkv, n_split, rows_per_split, scale, st);
  if (q_dtype == 1 && quant)
    return launch_d<__nv_bfloat16, int8_t>(D, q, k, v, ks, vs, lengths, part_acc,
                                           part_ml, out, B, T, Hq, Hkv, n_split,
                                           rows_per_split, scale, st);
  return cudaErrorInvalidValue;
}
