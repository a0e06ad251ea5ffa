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
// bf16 queries, bf16 or int8 pools (paged_tc_kernel, helpers in mma.cuh):
// grid (split, kv head, sequence), a split being a run of whole pages.
// The n_rep <= 8 query heads of the kv head are the rows of an m16 A
// fragment (q scaled and rounded to bf16 as the plain version does, rows
// n_rep..15 zero). Each of the block's 4 warps streams its own chunks of
// C = 32 rows with its own online softmax, so no block barrier waits per
// tile. A chunk never crosses a page: with bs < 32 its rows past the page's
// end are masked (a second, 16-row chunk size for bs <= 16 made ptxas spill
// in its bf16 kernel, and the engines use bs = 64). The warp reads its
// chunk's table entry (the next one's load is issued with the
// current copies), copies the chunk's K and V rows of this kv head with
// 16-byte cp.async into a two-stage ring of its own (16 KB in flight per
// warp at D = 64, bf16), and rows at or past lengths[b] or past the page's
// end arrive as zeros (src-size 0): 0 x NaN is NaN, so rows that are not
// read must not be in the tile. Their scores are set to -1e30 and their
// probabilities to 0 with selects. Pages at or past ceil(lengths[b] / bs)
// are never touched. Scores are an mma against K read by ldmatrix, the
// softmax is taken once per chunk with quad shuffles, and P . V is an mma
// whose A rows 0-7 are bf16(p) and rows 8-15 bf16(p - bf16(p)) (the hi/lo
// split: the padding rows carry the low half, so one mma does both), summed
// at the end. int8 rows convert to bf16 exactly (|x| <= 127): they are
// copied as int8 and widened in shared memory; the K scale multiplies the
// score and the V scale the probability before the split, the plain
// version's order up to fp32 rounding. At the end the warps merge their
// states through shared memory and write one partial per split, which
// decode_split.cuh's combine_kernel merges, as for kernel B.
//
// fp32 queries (fp32 or int8 pools) stay on the CUDA cores in kernel B's
// split-K walk (decode_split.cuh) with one table lookup per row: the tensor
// cores would round an fp32 query.
#include "decode_split.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace tc = ttsk::mma;

constexpr int NW = 4;  // warps per block, each streaming its own chunks
constexpr int C = 32;  // rows per chunk
constexpr int MAX_REP = ttsk::decode::MAX_REP;

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

template <typename TC, int D>
__global__ void __launch_bounds__(NW * 32)
paged_tc_kernel(const bf16* __restrict__ q, const TC* __restrict__ kp,
                const TC* __restrict__ vp, const float* __restrict__ ks,
                const float* __restrict__ vs, const int* __restrict__ table,
                const int* __restrict__ lengths, float* __restrict__ part_acc,
                float* __restrict__ part_ml, int P, int N, int bs, int Hq, int Hkv,
                int n_split, int pages_per_split, float scale) {
  using L = Layout<TC, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_rep = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  unsigned char* ws = smem + warp * L::WARP;

  // this split's chunks: rows [r_begin, r_end) of the sequence
  const int len = min(lengths[b], P * bs);
  const int cpp = (bs + C - 1) / C;  // chunks per page
  const int page0 = split * pages_per_split;
  const int r_begin = page0 * bs;
  const int r_end = min(len, r_begin + pages_per_split * bs);
  int n_chunks = 0;
  if (r_end > r_begin) {
    const int rows = r_end - r_begin;
    n_chunks = rows / bs * cpp + (rows % bs + C - 1) / C;
  }

  // q rows g < n_rep as A fragments (rows g + 8 stay zero)
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
      qf[kk][0] = tc::pack_bf16(x[0], x[1]);
      qf[kk][1] = 0u;
      qf[kk][2] = tc::pack_bf16(x[2], x[3]);
      qf[kk][3] = 0u;
    }
  }

  const auto block_of = [&](int c) {
    const int blk = table[static_cast<long>(b) * P + page0 + c / cpp];
    return min(max(blk, 0), N - 1);  // clamped into the pool, as XLA clamps a gather index
  };
  // chunk c's rows: sequence row t0 + j is page row r0 + j; valid below
  // both the page's end and the length
  const auto rows_of = [&](int c, int& t0, int& r0) {
    r0 = (c % cpp) * C;
    t0 = (page0 + c / cpp) * bs + r0;
  };
  const auto issue = [&](int c, int blk, int st) {
    int t0, r0;
    rows_of(c, t0, r0);
    unsigned char* sg = ws + st * L::STAGE;
    const long head_row0 = static_cast<long>(blk) * bs * Hkv + hk;
    constexpr int CH = D * static_cast<int>(sizeof(TC)) / 16;  // 16-byte pieces per row
#pragma unroll
    for (int i = lane; i < C * CH; i += 32) {
      const int j = i / CH, p = i % CH;
      const bool ok = r0 + j < bs && t0 + j < len;
      const long hr = head_row0 + static_cast<long>(ok ? r0 + j : 0) * Hkv;
      tc::cp_async16(sg + j * L::ROW + p * 16,
                     reinterpret_cast<const char*>(kp + hr * D) + p * 16, ok);
      tc::cp_async16(sg + (C + j) * L::ROW + p * 16,
                     reinterpret_cast<const char*>(vp + hr * D) + p * 16, ok);
    }
    if (L::Q8 && lane < C) {
      const bool ok = r0 + lane < bs && t0 + lane < len;
      const long hr = head_row0 + static_cast<long>(ok ? r0 + lane : 0) * Hkv;
      tc::cp_async4(sg + L::SCALES + lane * 4, ks + hr, ok);
      tc::cp_async4(sg + L::SCALES + (C + lane) * 4, vs + hr, ok);
    }
  };

  float m = ttsk::NEG_INF, l = 0.f;  // row g; l is this lane's part of the sum
  float acc[D / 8][4];               // [0..1] row g: hi . V; [2..3]: lo . V
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int c = warp;
  int blk_next = c < n_chunks ? block_of(c) : 0;
  if (c < n_chunks) issue(c, blk_next, 0);
  tc::cp_async_commit();
  if (c + NW < n_chunks) blk_next = block_of(c + NW);
  for (int it = 0; c < n_chunks; ++it, c += NW) {
    const int st = it & 1;
    if (c + NW < n_chunks) issue(c + NW, blk_next, st ^ 1);
    tc::cp_async_commit();
    if (c + 2 * NW < n_chunks) blk_next = block_of(c + 2 * NW);  // in flight with the copies
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

    int t0, r0;
    rows_of(c, t0, r0);
    bool ok[C / 8][2];
    float mx = m;
#pragma unroll
    for (int n = 0; n < C / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = n * 8 + t4 * 2 + e;
        ok[n][e] = r0 + j < bs && t0 + j < len;
        float x = s[n][e];
        if constexpr (L::Q8) x *= ksm[j];
        s[n][e] = ok[n][e] ? x : ttsk::NEG_INF;
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
    for (int kc = 0; kc < C / 16; ++kc) {
      uint32_t a[4];  // rows 0-7: bf16(p); rows 8-15: bf16(p - bf16(p))
      tc::split_bf16(s[2 * kc][0], s[2 * kc][1], a[0], a[1]);
      tc::split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], a[2], a[3]);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t r[4];
        tc::ldmatrix_x4_trans(r, &Vt[(kc * 16 + ((lane / 8) % 2) * 8 + lane % 8) * L::LD +
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
  // the lo rows 8-15 of acc are the same query rows as 0-7: fold them in
  __syncthreads();  // every warp is done with its tiles: reuse shared memory
  float* sm_m = reinterpret_cast<float*>(smem);  // [NW][MAX_REP]
  float* sm_l = sm_m + NW * MAX_REP;             // [NW][MAX_REP]
  float* sm_acc = sm_l + NW * MAX_REP;           // [NW][MAX_REP][D]
  if (g < n_rep) {
    if (t4 == 0) {
      sm_m[warp * MAX_REP + g] = m;
      sm_l[warp * MAX_REP + g] = l;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        sm_acc[(warp * MAX_REP + g) * D + n * 8 + t4 * 2 + e] = acc[n][e] + acc[n][e + 2];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_rep * D; i += NW * 32) {
    const int r = i / D, d = i % D;
    float mxw = ttsk::NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mxw = fmaxf(mxw, sm_m[w * MAX_REP + r]);
    float tot = 0.f, av = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(sm_m[w * MAX_REP + r] - mxw);
      tot += sm_l[w * MAX_REP + r] * f;
      av += sm_acc[(w * MAX_REP + r) * D + d] * f;
    }
    const long pi = ((static_cast<long>(b) * Hkv + hk) * n_split + split) * n_rep + r;
    part_acc[pi * D + d] = av;
    if (d == 0) {
      part_ml[pi * 2] = mxw;
      part_ml[pi * 2 + 1] = tot;
    }
  }
}

template <typename TC, int D>
cudaError_t launch_tc(const ttsk::decode::Args& a, const int* table, int P, int N, int bs,
                      int pages_per_split) {
  constexpr int smem = NW * Layout<TC, D>::WARP;
  static_assert(smem >= (2 * NW * MAX_REP + NW * MAX_REP * D) * 4, "merge buffers fit");
  cudaError_t err = cudaFuncSetAttribute(
      paged_tc_kernel<TC, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  paged_tc_kernel<TC, D><<<dim3(a.n_split, a.Hkv, a.B), NW * 32, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const TC*>(a.k), static_cast<const TC*>(a.v),
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs), table,
      static_cast<const int*>(a.lengths), static_cast<float*>(a.part_acc),
      static_cast<float*>(a.part_ml), P, N, bs, a.Hq, a.Hkv, a.n_split, pages_per_split,
      a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ttsk::decode::combine_kernel<bf16, D><<<dim3(a.Hkv, a.B), 256, 0, a.stream>>>(
      static_cast<const float*>(a.part_acc), static_cast<const float*>(a.part_ml),
      static_cast<bf16*>(a.out), a.Hq, a.Hkv, a.n_split);
  return cudaGetLastError();
}

template <typename TC>
cudaError_t run_tc(int D, const ttsk::decode::Args& a, const int* table, int P, int N, int bs,
                   int pages_per_split) {
  if (D == 64) return launch_tc<TC, 64>(a, table, P, N, bs, pages_per_split);
  if (D == 128) return launch_tc<TC, 128>(a, table, P, N, bs, pages_per_split);
  return cudaErrorInvalidValue;
}

bool aligned(const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

}  // namespace

// Pools and scales as above; table [B, P] and lengths [B] int32. part_acc
// [B, Hkv, n_split, n_rep, D] and part_ml [B, Hkv, n_split, n_rep, 2] are
// fp32 scratch the caller allocates. q_dtype: 0 float32, 1 bfloat16; quant:
// the pools are int8 with scales. With bf16 q the pools must start 16-byte
// aligned and q and the scales 4-byte aligned (the wrapper checks). Returns
// cudaGetLastError() after the launches.
extern "C" int paged_decode_fwd(const void* q, const void* k_pool, const void* v_pool,
                                const void* ks, const void* vs, const void* table,
                                const void* lengths, void* part_acc, void* part_ml,
                                void* out, int B, int P, int N, int bs, int Hq,
                                int Hkv, int D, int layer, int n_split,
                                int rows_per_split, float scale, int q_dtype,
                                int quant, void* stream) {
  if (P < 1 || N < 1 || bs < 1 || rows_per_split % bs != 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq / Hkv > MAX_REP || n_split < 1 || rows_per_split < 1 || (quant && (!ks || !vs)) ||
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
  const int* tab = static_cast<const int*>(table);
  if (q_dtype == 0) {  // CUDA cores
    const ttsk::decode::PagedRows rows{tab, P, bs, N, Hkv};
    if (!quant) return ttsk::decode::launch_d<float, float>(D, a, rows);
    return ttsk::decode::launch_d<float, int8_t>(D, a, rows);
  }
  if (q_dtype != 1 || !aligned(a.k, 16) || !aligned(a.v, 16) || !aligned(q, 4) ||
      (quant && (!aligned(a.ks, 4) || !aligned(a.vs, 4))))
    return cudaErrorInvalidValue;
  if (quant) return run_tc<int8_t>(D, a, tab, P, N, bs, rows_per_split / bs);
  return run_tc<bf16>(D, a, tab, P, N, bs, rows_per_split / bs);
}
