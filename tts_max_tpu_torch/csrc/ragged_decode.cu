// Kernel C: ragged decode attention, one new token per sequence against a
// padded contiguous KV cache, walking only each sequence's valid rows.
//
// Replaces: tts_max_tpu/ops/pallas_decode.py, ragged_decode_attention (the
// Pallas kernel of its pallas_call: grid (B,), a static loop over kv heads
// around an online-softmax loop over 128-row blocks whose trip count is
// ceil(lengths[b] / 128)).
//
// What it computes: out[b, h] = softmax_t(q[b, h] * D^-1/2 . K[b, t, h/n_rep]
// over t < lengths[b]) @ V[b, t, h/n_rep], over a bf16 or fp32 cache in q's
// dtype. Unlike kernel B, the scaled query stays in fp32 (it is not rounded
// to q's dtype), and a length of 0 gives zeros.
//
// What bounds it on the H100: bytes, as for kernel B: 2 * len * Hkv * D *
// sizeof(cache) bytes over 3.35 TB/s.
//
// The design is kernel B's (the TPU's sequential grid over a sequence's
// blocks becomes split-K over blocks and a combine): bf16 runs the
// tensor-core body of decode_tc.cuh with ContiguousRows and q split into
// bf16 hi + lo in the m16 fragment's rows 0-7 and 8-15, which keeps ~16
// significant bits of the fp32 scaled query at no extra mma; fp32 runs the
// CUDA-core split-K walk of decode_split.cuh, where the query stays fp32.
// Chunks at or past lengths[b] are never touched. A length of 0 leaves every
// split's partial at (-1e30, 0, 0), which the combine turns into exact
// zeros.
#include "decode_tc.cuh"

// q [B, Hq, D], k/v [B, T, Hkv, D] and out [B, Hq, D] in one dtype (0
// float32, 1 bfloat16), lengths [B] int32. part_acc [B, Hkv, n_split, n_rep,
// D] and part_ml [B, Hkv, n_split, n_rep, 2] are fp32 scratch the caller
// allocates; rows_per_split is a multiple of 32. With bf16 the caches must
// start 16-byte aligned and q 4-byte aligned (the wrapper checks). Returns
// cudaGetLastError() after the launches.
extern "C" int ragged_decode_fwd(const void* q, const void* k, const void* v,
                                 const void* lengths, void* part_acc, void* part_ml,
                                 void* out, int B, int T, int Hq, int Hkv, int D,
                                 int n_split, int rows_per_split, float scale, int dtype,
                                 void* stream) {
  namespace dec = ttsk::decode;
  const dec::Args a{q, k, v, nullptr, nullptr, lengths, part_acc, part_ml, out,
                    B, Hq, Hkv, D, n_split, rows_per_split, scale, dtype, 0,
                    static_cast<cudaStream_t>(stream)};
  const cudaError_t err = dec::check_args(a, T, dec::C);
  if (err != cudaSuccess) return err;
  const dec::ContiguousRows rows{T, Hkv};
  if (dtype == 0) return dec::run_split(a, rows);
  if (D == 64) return dec::launch_tc<dec::bf16, 64, true>(a, rows);
  return dec::launch_tc<dec::bf16, 128, true>(a, rows);
}
