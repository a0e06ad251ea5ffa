// Tensor-core and asynchronous-copy helpers shared by the bf16 paths of
// kernel A (flash_attention.cu), of the decode body decode_tc.cuh (kernels
// B and C and the paged kernel) and of the quantized product
// (quant_matmul.cu).
//
// Fragment layouts of mma.m16n8k16 (row-major A 16x16, column-major B
// 16x8, fp32 C 16x8), for lane = 4 * g + t:
//   A: a[0] row g, cols 2t..2t+1; a[1] row g+8, cols 2t..; a[2] row g,
//      cols 2t+8..; a[3] row g+8, cols 2t+8..
//   B: b0 k rows 2t..2t+1, col g; b1 k rows 2t+8.., col g
//   C: c[0..1] row g, cols 2t, 2t+1; c[2..3] row g+8, the same cols
// Each bf16x2 register holds the lower column (or k row) in its low half.
// ldmatrix.x4 reads four 8x8 b16 matrices whose row addresses come from
// lanes 0-7, 8-15, 16-23 and 24-31; lane 4 * g + t receives elements
// (g, 2t..2t+1) of each, which are these fragments' element pairs.
#pragma once

#include <cstring>

#include "common.cuh"

namespace ttsk {
namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, in flight until the group is waited for.
// With fill false the copy reads nothing and writes 16 zero bytes (src-size
// 0): rows that must not reach the tensor cores arrive as zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared (a scale), zero-filled when fill is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(fill ? 4 : 0)
               : "memory");
}

// 4, 8 or 16 bytes (vec) global -> shared; with fill false nothing is read
// and vec zero bytes are written. 16 bytes bypass L1 (.cg), as cp_async16.
__device__ __forceinline__ void cp_async_vec(void* dst, const void* src, int vec, bool fill) {
  const uint32_t d = smem_addr(dst);
  if (vec == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(fill ? 16 : 0)
                 : "memory");
  else if (vec == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                 "r"(fill ? 8 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(fill ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b, bf16 operands, fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// Two fp32 values rounded (to nearest even) into one bf16x2, x in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  return bits(__floats2bfloat162_rn(x, y));
}

// The hi/lo split of a pair of fp32 values (probabilities, or kernel C's
// scaled query): hi = bf16(p), lo = bf16(p - hi). hi + lo carries about 16
// significant bits, so a product with P as the A operand errs by ~2^-16
// |p| where bf16 P alone errs by up to 2^-8 |p|.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// The exact three-term split of a pair of fp32 values: hi = bf16(x), mid =
// bf16(x - hi), lo = bf16(x - hi - mid). Each residual is exact in fp32 and
// holds at most 16, then 8, significant bits, so hi + mid + lo == x (24
// bits): a product of an exact bf16 operand with each term is exact in fp32.
__device__ __forceinline__ void split3_bf16(float x, float y, uint32_t& hi, uint32_t& mid,
                                            uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = bits(h);
  mid = bits(m);
  lo = pack_bf16(rx - mf.x, ry - mf.y);
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the SFU (ex2.approx.ftz: relative error ~2^-22, results below
// 2^-126 flushed to 0), far inside the bf16 tolerance of the outputs.
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Four int8 values (one 32-bit word) to two bf16x2, exactly: each byte,
// biased by 128, becomes the low bits of the float 2^23 + (x + 128), from
// which one subtraction leaves x; |x| <= 128 is exact in bf16. This keeps
// the conversion on the FMA pipe instead of the slower int-to-float unit.
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u + i)) - 8388736.f;
  lo = pack_bf16(f[0], f[1]);
  hi = pack_bf16(f[2], f[3]);
}

}  // namespace mma
}  // namespace ttsk
