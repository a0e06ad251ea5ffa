// Paged decode attention: one new token per sequence against a block-pool
// KV cache, read through a block table.
//
// Replaces all three Pallas kernels of tts_max_tpu/ops/paged_attention.py,
// which compute one function and differ only in how they schedule it on a
// TPU: paged_decode_attention_dense (pallas_call :536, block-diagonal MXU
// products, with its stacked layer= form), paged_decode_attention_dma
// (:246, grid (B,) with double-buffered page DMAs) and
// paged_decode_attention (:663, grid (B, P) with BlockSpec revisiting).
// None of that scheduling carries over to Hopper; their common oracle is
// paged_decode_attention_xla.
//
// What it computes: out[b, h] = softmax over t < lengths[b] of
// q[b, h] . K[t] * D^-1/2, weighting V[t], where row t of sequence b is row
// t % bs of pool block table[b, t / bs]. Pools are [N, bs, Hkv, D] bf16 or
// fp32 in q's dtype, or int8 with fp32 scales [N, bs, Hkv] (the TPU's lane
// padding of the scales has no counterpart here). With layer >= 0 the pools
// are the stacked [L, N, bs, Hkv, D] caches and the pool pointers are
// offset to that layer: nothing is copied.
//
// What bounds it on the H100: bytes, as for kernel B. Each live row is read
// once for n_rep multiply-adds per element; the bound is the bytes of the
// live pages (2 * pages * bs * Hkv * D * sizeof(pool), plus their scales)
// over 3.35 TB/s: 8 sequences of ~1100 rows at Hkv 8, D 64 in bf16 move
// 18 MB, 5.4 us. Reaching it takes bytes in flight (Little's law wants
// ~25 KB per SM), not arithmetic.
//
// bf16 queries, bf16 or int8 pools: the tensor-core body of decode_tc.cuh
// with PagedRows and q rounded as the plain version rounds it (a split is
// a run of whole pages; a chunk of 32 rows never crosses a page: with bs <
// 32 its rows past the page's end are masked; a second, 16-row chunk size
// for bs <= 16 made ptxas spill in its bf16 kernel, and the engines use bs
// = 64). fp32 queries (fp32 or int8 pools) stay on the CUDA cores in the
// split-K walk of decode_split.cuh with one table lookup per row: the
// tensor cores would round an fp32 query.
#include "decode_tc.cuh"

// Pools and scales as above; table [B, P] and lengths [B] int32. part_acc
// [B, Hkv, n_split, n_rep, D] and part_ml [B, Hkv, n_split, n_rep, 2] are
// fp32 scratch the caller allocates; a split is rows_per_split / bs whole
// pages. q_dtype: 0 float32, 1 bfloat16; quant: the pools are int8 with
// scales. With bf16 q the pools must start 16-byte aligned and q and the
// scales 4-byte aligned (the wrapper checks). Returns cudaGetLastError()
// after the launches.
extern "C" int paged_decode_fwd(const void* q, const void* k_pool, const void* v_pool,
                                const void* ks, const void* vs, const void* table,
                                const void* lengths, void* part_acc, void* part_ml,
                                void* out, int B, int P, int N, int bs, int Hq,
                                int Hkv, int D, int layer, int n_split,
                                int rows_per_split, float scale, int q_dtype,
                                int quant, void* stream) {
  namespace dec = ttsk::decode;
  if (P < 1 || N < 1 || bs < 1) return cudaErrorInvalidValue;
  const long rows_per_layer = static_cast<long>(N) * bs * Hkv;  // head rows
  const long off = layer > 0 ? layer * rows_per_layer : 0;
  const int elt = quant ? 1 : (q_dtype == 0 ? 4 : 2);
  const auto shift = [&](const void* p, long n) -> const void* {
    return p == nullptr ? nullptr : static_cast<const char*>(p) + n;
  };
  const dec::Args a{q, shift(k_pool, off * D * elt), shift(v_pool, off * D * elt),
                    shift(ks, off * 4), shift(vs, off * 4), lengths, part_acc, part_ml,
                    out, B, Hq, Hkv, D, n_split, rows_per_split, scale, q_dtype, quant,
                    static_cast<cudaStream_t>(stream)};
  const cudaError_t err = dec::check_args(a, static_cast<long>(P) * bs, bs);
  if (err != cudaSuccess) return err;
  const dec::PagedRows rows{static_cast<const int*>(table), P, bs, N, Hkv};
  if (q_dtype == 0) return dec::run_split(a, rows);
  return dec::run_tc_rounded(a, rows);
}
