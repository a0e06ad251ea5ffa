// The tensor-core one-token decode body that kernel B (flash_decode.cu),
// kernel C (ragged_decode.cu) and the paged kernel (paged_decode.cu) are
// built from: bf16 queries over a bf16 or int8 cache, templated on the row
// policy (decode_split.cuh: ContiguousRows for B and C, PagedRows for the
// paged kernel) and on how q enters the tensor cores.
//
// What it computes: out[b, h] = softmax over t < lengths[b] of
// q[b, h] . K[b, t, h/n_rep] * D^-1/2, weighting V[b, t, h/n_rep].
//
// What bounds it on the H100: bytes. Each live row is read once for n_rep
// multiply-adds per element (4 at Llama-3.2-1B), far below the card's ~295
// operations per byte: the bound is the bytes of the live rows (2 * rows *
// Hkv * D * sizeof(cache), plus their scales) over 3.35 TB/s. Reaching it
// takes bytes in flight (Little's law wants ~25 KB per SM), not arithmetic.
//
// The design. Grid (split, kv head, sequence); a split is a run of whole
// chunks of C = 32 rows (of whole pages for the paged policy, where a chunk
// never crosses a page and its rows past the page's end are masked). The
// n_rep <= 8 query heads of the kv head are the rows of an m16 A fragment:
//   - rounded (B and the paged kernel, the plain versions' q): rows 0-7
//     are bf16(q * scale), rows 8-15 zero;
//   - split (C, whose plain version keeps the scaled query in fp32): rows
//     0-7 are hi = bf16(qs), rows 8-15 lo = bf16(qs - hi), qs = q * scale
//     in fp32; the score of query row g is then c[0..1] + c[2..3] of the
//     same lane (hi . K + lo . K, ~16 significant bits of qs), at no extra
//     mma.
// Each of the block's 4 warps streams its own chunks with its own online
// softmax, so no block barrier waits per chunk. The warp looks up its
// chunk (the paged policy's table entry: the next one's load is issued with
// the current copies), copies the chunk's K and V rows of this kv head with
// 16-byte cp.async into a two-stage ring of its own (16 KB in flight per
// warp at D = 64, bf16), and rows at or past lengths[b] (or past the
// page's end) arrive as zeros (src-size 0): 0 x NaN is NaN, so rows that
// are not read must not be in the tile. Their scores are set to -1e30 and
// their probabilities to 0 with selects. Chunks past the length are never
// touched. Scores are an mma against K read by ldmatrix, the softmax is
// taken once per chunk with quad shuffles, and P . V is an mma whose A rows
// 0-7 are bf16(p) and rows 8-15 bf16(p - bf16(p)) (the hi/lo split of P:
// the padding rows carry the low half, so one mma does both), summed at the
// end. int8 rows convert to bf16 exactly (|x| <= 127): they are copied as
// int8 and widened in shared memory; the K scale multiplies the score and
// the V scale the probability before the split, the plain version's order
// up to fp32 rounding. At the end the warps merge their states
// (decode_split.cuh's merge_warps) and write one partial per split, which
// combine_kernel merges.
#pragma once

#include "decode_split.cuh"
#include "mma.cuh"

namespace ttsk {
namespace decode {

using bf16 = __nv_bfloat16;

// Shared memory of one warp: two stages, each the chunk's K rows, V rows
// (bf16 rows padded to D + 8 for ldmatrix; int8 rows as they lie) and, for
// int8, the rows' K and V scales; for int8 also one widened bf16 tile.
template <typename TC, int D>
struct Layout {
  static constexpr bool Q8 = sizeof(TC) == 1;
  static constexpr int LD = D + 8;  // bf16 elements per tile row
  static constexpr int ROW = Q8 ? D : LD * 2;  // bytes of one staged row
  static constexpr int SCALES = 2 * C * ROW;   // offset of the scales in a stage
  static constexpr int STAGE = SCALES + (Q8 ? 2 * C * 4 : 0);
  static constexpr int WIDE = 2 * STAGE;       // offset of the widened tile
  static constexpr int WARP = WIDE + (Q8 ? 2 * C * LD * 2 : 0);
  static_assert(ROW % 16 == 0 && STAGE % 16 == 0, "16-byte rows and stages");
};

template <typename TC, int D, bool QSPLIT, typename Rows>
__global__ void __launch_bounds__(NW * 32)
tc_kernel(const bf16* __restrict__ q, const TC* __restrict__ kc, const TC* __restrict__ vc,
          const float* __restrict__ ks, const float* __restrict__ vs,
          const int* __restrict__ lengths, float* __restrict__ part_acc,
          float* __restrict__ part_ml, Rows rows, int Hq, int Hkv, int n_split,
          int rows_per_split, float scale) {
  namespace tc = ttsk::mma;
  using L = Layout<TC, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_rep = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  unsigned char* ws = smem + warp * L::WARP;

  // this split's rows [t_begin, t_end) of the sequence
  const int len = min(lengths[b], rows.cap());
  const int t_begin = split * rows_per_split;
  const int t_end = min(len, t_begin + rows_per_split);
  const int n_chunks = t_end > t_begin ? rows.chunks(t_end - t_begin) : 0;

  // q rows g < n_rep as A fragments (rows g + 8: zero, or q's low half)
  uint32_t qf[D / 16][4];
  {
    const bf16* qr = q + (static_cast<long>(b) * Hq + hk * n_rep + g) * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (g < n_rep) {
        const float2 lo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(qr + kk * 16 + t4 * 2));
        const float2 hi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(qr + kk * 16 + 8 + t4 * 2));
        x[0] = lo.x * scale, x[1] = lo.y * scale, x[2] = hi.x * scale, x[3] = hi.y * scale;
      }
      if constexpr (QSPLIT) {
        tc::split_bf16(x[0], x[1], qf[kk][0], qf[kk][1]);
        tc::split_bf16(x[2], x[3], qf[kk][2], qf[kk][3]);
      } else {
        qf[kk][0] = tc::pack_bf16(x[0], x[1]);
        qf[kk][1] = 0u;
        qf[kk][2] = tc::pack_bf16(x[2], x[3]);
        qf[kk][3] = 0u;
      }
    }
  }

  const auto start_of = [&](int c) { return t_begin + rows.chunk_start(c); };
  const auto issue = [&](int c, int looked, int st) {
    const int t0 = start_of(c);
    const int n = rows.valid(t0, len);
    const long base = rows.row(b, t0, hk, looked);  // head row of the chunk's row 0
    unsigned char* sg = ws + st * L::STAGE;
    constexpr int CH = D * static_cast<int>(sizeof(TC)) / 16;  // 16-byte pieces per row
#pragma unroll
    for (int i = lane; i < C * CH; i += 32) {
      const int j = i / CH, p = i % CH;
      const bool ok = j < n;
      const long hr = base + static_cast<long>(ok ? j : 0) * Hkv;
      tc::cp_async16(sg + j * L::ROW + p * 16,
                     reinterpret_cast<const char*>(kc + hr * D) + p * 16, ok);
      tc::cp_async16(sg + (C + j) * L::ROW + p * 16,
                     reinterpret_cast<const char*>(vc + hr * D) + p * 16, ok);
    }
    if (L::Q8 && lane < C) {
      const bool ok = lane < n;
      const long hr = base + static_cast<long>(ok ? lane : 0) * Hkv;
      tc::cp_async4(sg + L::SCALES + lane * 4, ks + hr, ok);
      tc::cp_async4(sg + L::SCALES + (C + lane) * 4, vs + hr, ok);
    }
  };

  float m = NEG_INF, l = 0.f;  // row g; l is this lane's part of the sum
  float acc[D / 8][4];         // [0..1] row g: hi . V; [2..3]: lo . V
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int c = warp;
  int next = c < n_chunks ? rows.lookup(b, start_of(c)) : 0;
  if (c < n_chunks) issue(c, next, 0);
  tc::cp_async_commit();
  if (c + NW < n_chunks) next = rows.lookup(b, start_of(c + NW));
  for (int it = 0; c < n_chunks; ++it, c += NW) {
    const int st = it & 1;
    if (c + NW < n_chunks) issue(c + NW, next, st ^ 1);
    tc::cp_async_commit();
    // in flight with the copies
    if (c + 2 * NW < n_chunks) next = rows.lookup(b, start_of(c + 2 * NW));
    tc::cp_async_wait<1>();
    __syncwarp();

    const unsigned char* sg = ws + st * L::STAGE;
    const bf16* Kt;
    if constexpr (L::Q8) {
      // widen the int8 K and V rows to bf16 (exact) in the warp's wide tile
      bf16* wide = reinterpret_cast<bf16*>(ws + L::WIDE);
      constexpr int PR = D / 16;  // 16-value pieces per row
#pragma unroll
      for (int i = lane; i < 2 * C * PR; i += 32) {
        const int row = i / PR, p = i % PR;
        const uint4 raw = *reinterpret_cast<const uint4*>(sg + row * L::ROW + p * 16);
        uint32_t out[8];
        tc::int8x4_to_bf16(raw.x, out[0], out[1]);
        tc::int8x4_to_bf16(raw.y, out[2], out[3]);
        tc::int8x4_to_bf16(raw.z, out[4], out[5]);
        tc::int8x4_to_bf16(raw.w, out[6], out[7]);
        int4* dst = reinterpret_cast<int4*>(wide + row * L::LD + p * 16);
        dst[0] = make_int4(out[0], out[1], out[2], out[3]);
        dst[1] = make_int4(out[4], out[5], out[6], out[7]);
      }
      __syncwarp();
      Kt = wide;
    } else {
      Kt = reinterpret_cast<const bf16*>(sg);
    }
    const bf16* Vt = Kt + C * L::LD;
    const float* ksm = reinterpret_cast<const float*>(sg + L::SCALES);
    const float* vsm = ksm + C;

    float s[C / 8][4];
#pragma unroll
    for (int n = 0; n < C / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < C / 16; ++n2) {
        uint32_t r[4];
        tc::ldmatrix_x4(r, &Kt[(n2 * 16 + (lane / 16) * 8 + lane % 8) * L::LD + kk * 16 +
                               ((lane / 8) % 2) * 8]);
        tc::mma_bf16(s[2 * n2], qf[kk], r[0], r[1]);
        tc::mma_bf16(s[2 * n2 + 1], qf[kk], r[2], r[3]);
      }
    }

    const int n_ok = rows.valid(start_of(c), len);
    bool ok[C / 8][2];
    float mx = m;
#pragma unroll
    for (int n = 0; n < C / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = n * 8 + t4 * 2 + e;
        ok[n][e] = j < n_ok;
        float x = s[n][e];
        if constexpr (QSPLIT) x += s[n][e + 2];  // + lo . K
        if constexpr (L::Q8) x *= ksm[j];
        s[n][e] = ok[n][e] ? x : NEG_INF;
        mx = fmaxf(mx, s[n][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = tc::exp2_fast((m - mx) * tc::LOG2E);
    m = mx;
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < C / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = n * 8 + t4 * 2 + e;
        const float p = ok[n][e] ? tc::exp2_fast((s[n][e] - mx) * tc::LOG2E) : 0.f;
        sum += p;
        float pv = p;
        if constexpr (L::Q8) pv = ok[n][e] ? p * vsm[j] : 0.f;
        s[n][e] = pv;
      }
    l = alpha * l + sum;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha;

#pragma unroll
    for (int kc2 = 0; kc2 < C / 16; ++kc2) {
      uint32_t a[4];  // rows 0-7: bf16(p); rows 8-15: bf16(p - bf16(p))
      tc::split_bf16(s[2 * kc2][0], s[2 * kc2][1], a[0], a[1]);
      tc::split_bf16(s[2 * kc2 + 1][0], s[2 * kc2 + 1][1], a[2], a[3]);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t r[4];
        tc::ldmatrix_x4_trans(r, &Vt[(kc2 * 16 + ((lane / 8) % 2) * 8 + lane % 8) * L::LD +
                                     n2 * 16 + (lane / 16) * 8]);
        tc::mma_bf16(acc[2 * n2], a, r[0], r[1]);
        tc::mma_bf16(acc[2 * n2 + 1], a, r[2], r[3]);
      }
    }
    __syncwarp();  // every lane is done with this stage before it is refilled
  }
  tc::cp_async_wait<0>();

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  __syncthreads();  // every warp is done with its tiles: reuse shared memory
  float* sm = reinterpret_cast<float*>(smem);
  if (g < n_rep) {
    if (t4 == 0) {
      sm[warp * MAX_REP + g] = m;
      sm[(NW + warp) * MAX_REP + g] = l;
    }
    // the lo rows 8-15 of acc are the same query rows as 0-7: fold them in
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        sm[2 * NW * MAX_REP + (warp * MAX_REP + g) * D + n * 8 + t4 * 2 + e] =
            acc[n][e] + acc[n][e + 2];
  }
  merge_warps<D>(sm, n_rep, ((static_cast<long>(b) * Hkv + hk) * n_split + split) * n_rep,
                 part_acc, part_ml);
}

template <typename TC, int D, bool QSPLIT, typename Rows>
cudaError_t launch_tc(const Args& a, Rows rows) {
  constexpr int smem = NW * Layout<TC, D>::WARP;
  static_assert(smem >= merge_bytes<D>(), "merge buffers fit");
  cudaError_t err = cudaFuncSetAttribute(tc_kernel<TC, D, QSPLIT, Rows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  tc_kernel<TC, D, QSPLIT, Rows><<<dim3(a.n_split, a.Hkv, a.B), NW * 32, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const TC*>(a.k), static_cast<const TC*>(a.v),
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int*>(a.lengths), static_cast<float*>(a.part_acc),
      static_cast<float*>(a.part_ml), rows, a.Hq, a.Hkv, a.n_split, a.rows_per_split,
      a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine<bf16, D>(a);
}

// bf16 queries with q rounded (B, the paged kernel) over a bf16 (quant 0)
// or int8 (quant 1) cache.
template <typename Rows>
cudaError_t run_tc_rounded(const Args& a, Rows rows) {
  if (a.q_dtype != 1) return cudaErrorInvalidValue;
  if (a.D == 64) return a.quant ? launch_tc<int8_t, 64, false>(a, rows)
                                : launch_tc<bf16, 64, false>(a, rows);
  if (a.D == 128) return a.quant ? launch_tc<int8_t, 128, false>(a, rows)
                                 : launch_tc<bf16, 128, false>(a, rows);
  return cudaErrorInvalidValue;
}

}  // namespace decode
}  // namespace ttsk
