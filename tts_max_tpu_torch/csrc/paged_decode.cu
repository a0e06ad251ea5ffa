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
// 18 MB, 5.4 us.
//
// What the design does about it: kernel B's split-K kernel
// (decode_split.cuh) with a block-table walk. Each block reads its own
// table entries (there is no scalar prefetch) and walks only pages below
// ceil(lengths[b] / bs), masking the rows at or past lengths[b] in the last
// one: pages a sequence does not own (the sink block 0, unallocated table
// entries, free blocks) are never loaded. A split is a run of whole pages,
// so a batch whose (sequence, kv head) pairs are fewer than the SMs still
// spreads over the card. Row loads are the lane-strided scalar loads of
// kernel B: every page starts at a fresh base, so nothing here assumes
// more alignment than one element.
#include "decode_split.cuh"

// Pools and scales as above; table [B, P] and lengths [B] int32. part_acc
// [B, Hkv, n_split, n_rep, D] and part_ml [B, Hkv, n_split, n_rep, 2] are
// fp32 scratch the caller allocates. Returns cudaGetLastError() after the
// launches.
extern "C" int paged_decode_fwd(const void* q, const void* k_pool, const void* v_pool,
                                const void* ks, const void* vs, const void* table,
                                const void* lengths, void* part_acc, void* part_ml,
                                void* out, int B, int P, int N, int bs, int Hq,
                                int Hkv, int D, int layer, int n_split,
                                int rows_per_split, float scale, int q_dtype,
                                int quant, void* stream) {
  if (P < 1 || N < 1 || bs < 1 || rows_per_split % bs != 0 ||
      static_cast<long>(n_split) * rows_per_split < static_cast<long>(P) * bs)
    return cudaErrorInvalidValue;
  const long rows_per_layer = static_cast<long>(N) * bs * Hkv;  // head rows
  const long off = layer > 0 ? layer * rows_per_layer : 0;
  const int elt = quant ? 1 : (q_dtype == 0 ? 4 : 2);
  const auto shift = [&](const void* p, long n) -> const void* {
    return p == nullptr ? nullptr : static_cast<const char*>(p) + n;
  };
  const ttsk::decode::Args a{q, shift(k_pool, off * D * elt), shift(v_pool, off * D * elt),
                             shift(ks, off * 4), shift(vs, off * 4), lengths,
                             part_acc, part_ml, out, B, Hq, Hkv, n_split,
                             rows_per_split, scale, static_cast<cudaStream_t>(stream)};
  const ttsk::decode::PagedRows rows{static_cast<const int*>(table), P, bs, N, Hkv};
  return ttsk::decode::run(D, q_dtype, quant, a, rows);
}
