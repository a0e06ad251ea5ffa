// Kernel B: flash decode attention, one new token per sequence against a
// contiguous KV cache.
//
// Replaces: tts_max_tpu/ops/pallas_decode.py, flash_decode_attention (the
// Pallas kernel of its pallas_call, contiguous [B, T, Hkv, D] form; the port
// passes cache[layer], a contiguous view, in place of the stacked form).
//
// What it computes: out[b, h] = softmax_t(bf16(q[b, h] * D^-1/2) .
// K[b, t, h/n_rep] over t < lengths[b]) @ V[b, :, h/n_rep]: the scaled query
// rounded to q's dtype, over a bf16 or fp32 cache in q's dtype, or an int8
// cache with fp32 scales [B, T, Hkv] per (token, head), dequantized in
// registers.
//
// What bounds it on the H100: bytes. Each live cache row is read once and
// used for n_rep (4 at Llama-3.2-1B) multiply-adds per element, far below
// the card's ~295 operations per byte: the bound is 2 * len * Hkv * D *
// sizeof(cache) bytes over 3.35 TB/s (2.1 MB, 0.63 us at len=1024 in bf16).
//
// What the design does about it: it reads only rows < lengths[b] (rows
// beyond the length, garbage or NaN, are never loaded into a product) and
// spreads them over enough blocks to keep many bytes in flight. bf16
// queries (bf16 or int8 cache) run the tensor-core body of decode_tc.cuh
// with ContiguousRows (row t of sequence b at cache[b, t]; a split is whole
// chunks of 32 rows) and q rounded; fp32 queries run the CUDA-core split-K
// walk of decode_split.cuh (the tensor cores would round an fp32 query).
#include "decode_tc.cuh"

// part_acc [B, Hkv, n_split, n_rep, D] and part_ml [B, Hkv, n_split, n_rep,
// 2] are fp32 scratch the caller allocates; rows_per_split is a multiple of
// 32. With bf16 q the caches must start 16-byte aligned and q and the
// scales 4-byte aligned (the wrapper checks). Returns cudaGetLastError()
// after the launches.
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs, const void* lengths,
                                void* part_acc, void* part_ml, void* out, int B,
                                int T, int Hq, int Hkv, int D, int n_split,
                                int rows_per_split, float scale, int q_dtype,
                                int quant, void* stream) {
  namespace dec = ttsk::decode;
  const dec::Args a{q, k, v, ks, vs, lengths, part_acc, part_ml, out,
                    B, Hq, Hkv, D, n_split, rows_per_split, scale, q_dtype, quant,
                    static_cast<cudaStream_t>(stream)};
  const cudaError_t err = dec::check_args(a, T, dec::C);
  if (err != cudaSuccess) return err;
  const dec::ContiguousRows rows{T, Hkv};
  if (q_dtype == 0) return dec::run_split(a, rows);
  return dec::run_tc_rounded(a, rows);
}
