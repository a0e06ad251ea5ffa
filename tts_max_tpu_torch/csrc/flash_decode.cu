// Kernel B: flash decode attention, one new token per sequence against a
// contiguous KV cache.
//
// Replaces: tts_max_tpu/ops/pallas_decode.py, flash_decode_attention (the
// Pallas kernel of its pallas_call, contiguous [B, T, Hkv, D] form; the port
// passes cache[layer], a contiguous view, in place of the stacked form).
//
// What it computes: out[b, h] = softmax_t(q[b, h] . K[b, t, h/n_rep] *
// D^-1/2 over t < lengths[b]) @ V[b, :, h/n_rep], over a bf16 or fp32 cache
// in q's dtype, or an int8 cache with fp32 scales [B, T, Hkv] per (token,
// head), dequantized in registers.
//
// What bounds it on the H100: bytes. Each live cache row is read once and
// used for n_rep (4 at Llama-3.2-1B) multiply-adds per element, far below
// the card's ~295 operations per byte: the bound is 2 * len * Hkv * D *
// sizeof(cache) bytes over 3.35 TB/s (2.1 MB, 0.63 us at len=1024 in bf16).
//
// What the design does about it: it reads only rows < lengths[b] (a dynamic
// trip count costs nothing here; rows beyond the length, garbage or NaN,
// are never loaded), and spreads those rows over enough blocks to keep many
// loads in flight: the split-K kernel of decode_split.cuh, with row t of
// sequence b at cache[b, t].
#include "decode_split.cuh"

// part_acc [B, Hkv, n_split, n_rep, D] and part_ml [B, Hkv, n_split, n_rep,
// 2] are fp32 scratch the caller allocates. Returns cudaGetLastError() after
// the launches.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs, const void* lengths,
                                void* part_acc, void* part_ml, void* out, int B,
                                int T, int Hq, int Hkv, int D, int n_split,
                                int rows_per_split, float scale, int q_dtype,
                                int quant, void* stream) {
  if (static_cast<long>(n_split) * rows_per_split < T) return cudaErrorInvalidValue;
  const ttsk::decode::Args a{q, k, v, ks, vs, lengths, part_acc, part_ml, out,
                             B, Hq, Hkv, n_split, rows_per_split, scale,
                             static_cast<cudaStream_t>(stream)};
  return ttsk::decode::run(D, q_dtype, quant, a, ttsk::decode::ContiguousRows{T, Hkv});
}
