// Kernel A: causal flash attention forward for prefill.
//
// Replaces: tts_max_tpu/ops/pallas_attention.py, flash_attention (the Pallas
// kernel _flash_kernel launched by _flash_fwd_impl's pallas_call).
//
// What it computes: out[b, s, h] = softmax_k(q[b, s, h] . k[b, k, h/n_rep] *
// D^-1/2, masked to k < kv_len and, when causal, k <= s) @ v[b, :, h/n_rep],
// with q, k, v in [B, S, H, D] layout. Query head h reads kv head
// h / (Hq/Hkv): GQA is native, K/V are never repeated in memory.
//
// What bounds it on the H100: operations. A causal prefill does about
// 2 * S^2 * Hq * D multiply-adds (6.7 GFLOP at S=1280, Hq=32, D=64) against
// 3 * S * H * D * 2 bytes of input, some 500 operations per byte, well above
// the card's ~295 operations per byte of bf16 balance. So the products
// belong on the tensor cores, and what decides the time at these sizes (a
// few hundred blocks of 64 rows) is keeping loads in flight behind them.
//
// bf16 (flash_fwd_tc, FlashAttention-2's shape written for this card with
// mma.sync and cp.async, helpers in mma.cuh): one block of 4 warps per
// (64-row q tile, query head, batch), the heaviest causal tiles scheduled
// first. Each warp owns 16 query rows; its Q fragments are loaded once and
// stay in registers. 64-row K and V tiles of the block's kv head come
// through a two-stage cp.async ring (tile j+1 in flight while tile j is
// computed; one __syncthreads per tile publishes it and frees the stage the
// next copy reuses), rows padded by 16 bytes against ldmatrix bank
// conflicts, rows past S zero-filled by the copy. S = Q K^T is an mma with
// K read by ldmatrix (K row-major is K^T column-major); the fp32 score is
// then multiplied by the scale (the plain version scales q in fp32 before
// the product: the two differ by fp32 rounding, and at D = 64 the scale
// 0.125 is exact) and by log2(e), so that the softmax's exponentials are
// single SFU ex2 instructions. Only tiles that cross the causal diagonal or
// kv_len compare positions. The online softmax keeps each row's max and sum
// in fp32, reduced over the 4 lanes of a C-fragment row with two shuffles. P
// goes from the C fragments straight into A fragments as a hi/lo pair of
// bf16 (hi = bf16(p), lo = bf16(p - hi)), each multiplied with V (read by
// ldmatrix.trans) into one fp32 accumulator: P rounded once to bf16 errs by
// up to 2^-8 |p|, which near-zero outputs of random V do not tolerate
// (tests/test_torch_tc_numerics.py); the pair errs by ~2^-16. Rows in
// [kv_len, S) are not filled: the zero-padded input gives p = 0 against
// finite V, as in the Pallas kernel (a NaN there would reach the output).
//
// Training: with a non-null lse pointer both paths also write each query
// row's log-sum-exp of the scaled scores, fp32 [B, Hq, S], IN BASE 2:
// lse[b, h, s] = log2(sum_k 2^(log2(e) * D^-1/2 * q.k)) over the row's
// unmasked keys, which is the natural log-sum-exp times log2(e). The
// tensor-core path works in base 2 already (its running max is scaled by
// log2(e)), so the value is m + log2(l); the fp32 path converts its natural
// m + log(l). The backward kernel (flash_attention_bwd.cu) recomputes each
// probability as exp2(log2(e) * D^-1/2 * q.k - lse). With a non-null o_lo
// (bf16 only) the tensor-core path also writes O's rounding residual,
// o_lo = bf16(o - bf16(o)) in [B, S, Hq, D]: O_hi + O_lo carries ~16
// significant bits, so the backward's D = sum(dO * O) is taken from the
// unrounded O (a bf16 residual moves half the bytes of an fp32 copy of O and
// leaves the bf16 output as it is). Serving passes null for both and the
// kernels run exactly as without them.
//
// fp32 (flash_fwd_kernel) stays on the CUDA cores: the tensor cores would
// round fp32 inputs, and the fp32 small-model check runs this path. One
// block of 256 threads per (q tile, head, batch) stages the scaled Q tile
// and each K and V tile in shared memory as fp32 and computes both
// products as 4x4 register micro-tiles of fmaf. Masked scores use -1e30 as
// the Pallas kernel does.
#include "mma.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int NT = 256;       // threads per block: a 16 x 16 grid
constexpr int RM = BQ / 16;   // score rows per thread
constexpr int CM = BK / 16;   // score columns per thread

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 int S, int Hq, int Hkv, int kv_len, int causal, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][D+1], pre-scaled
  float* Ks = Qs + BQ * (D + 1);    // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);    // [BK][D]
  float* Ps = Vs + BK * D;          // [BQ][BK+1]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const long q_stride = static_cast<long>(Hq) * D;   // between positions
  const long kv_stride = static_cast<long>(Hkv) * D;
  const T* qb = q + static_cast<long>(b) * S * q_stride + static_cast<long>(h) * D;
  const T* kb = k + static_cast<long>(b) * S * kv_stride + static_cast<long>(hk) * D;
  const T* vb = v + static_cast<long>(b) * S * kv_stride + static_cast<long>(hk) * D;
  T* ob = o + static_cast<long>(b) * S * q_stride + static_cast<long>(h) * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D, s = q0 + r;
    Qs[r * (D + 1) + c] = s < S ? ttsk::to_float(qb[s * q_stride + c]) * scale : 0.f;
  }

  float m[RM], l[RM], acc[RM][D / 16];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = ttsk::NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (kv_len + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks, Vs and Ps are consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D, s = k0 + r;
      const bool in = s < S;
      Ks[r * (D + 1) + c] = in ? ttsk::to_float(kb[s * kv_stride + c]) : 0.f;
      Vs[r * D + c] = in ? ttsk::to_float(vb[s * kv_stride + c]) : 0.f;
    }
    __syncthreads();

    float sc[RM][CM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CM; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[RM], bk[CM];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < CM; ++j) bk[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CM; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qp = q0 + ty + 16 * i;
      float rmax = ttsk::NEG_INF;
#pragma unroll
      for (int j = 0; j < CM; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp < kv_len && (!causal || kp <= qp);
        sc[i][j] = ok ? sc[i][j] : ttsk::NEG_INF;
        rmax = fmaxf(rmax, sc[i][j]);
      }
      // the 16 threads of a score row are 16 consecutive lanes of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < CM; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rsum += p;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      m[i] = m_new;
      l[i] = alpha * l[i] + rsum;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[RM], vv[D / 16];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = Ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < D / 16; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < D / 16; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      ttsk::store(&ob[qp * q_stride + tx + 16 * c], acc[i][c] * inv);
    if (lse != nullptr && tx == 0)  // l[i] is the whole row's sum in all 16 lanes
      lse[(static_cast<long>(b) * Hq + h) * S + qp] = (m[i] + logf(l[i])) * ttsk::mma::LOG2E;
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                       int B, int S, int Hq, int Hkv, int kv_len, int causal, float scale,
                       cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<float, D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, Hq, Hkv, kv_len,
      causal, scale);
  return cudaGetLastError();
}

// --- bf16: tensor cores -------------------------------------------------------

using bf16 = __nv_bfloat16;
namespace tc = ttsk::mma;

constexpr int TC_WARPS = BQ / 16;  // each warp owns one m16 tile of the block's rows
constexpr int TC_NT = TC_WARPS * 32;

template <int D>
struct TcConfig {
  static constexpr int LD = D + 8;  // padded row: 8 ldmatrix rows hit 8 bank groups
  static constexpr int SMEM = (BQ + 4 * BK) * LD * static_cast<int>(sizeof(bf16));
};

// The explicit floor of one block per SM lets ptxas keep 156 registers at
// D = 64 (221 at D = 128); left to its default it takes 135 (182) and the
// kernel runs 6-11% slower on the H100 (PERF.md, section 6).
template <int D>
__global__ void __launch_bounds__(TC_NT, 1)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
             bf16* __restrict__ o_lo, int S, int Hq, int Hkv, int kv_len, int causal,
             float scale) {
  constexpr int LD = TcConfig<D>::LD;
  constexpr int CH = D / 8;  // 16-byte pieces per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* Ks = Qs + BQ * LD;                       // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                   // [2][BK][LD]

  const int qt = gridDim.x - 1 - blockIdx.x;  // the heaviest causal tiles first
  const int q0 = qt * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;

  const long q_stride = static_cast<long>(Hq) * D;
  const long kv_stride = static_cast<long>(Hkv) * D;
  const bf16* qb = q + static_cast<long>(b) * S * q_stride + static_cast<long>(h) * D;
  const bf16* kb = k + static_cast<long>(b) * S * kv_stride + static_cast<long>(hk) * D;
  const bf16* vb = v + static_cast<long>(b) * S * kv_stride + static_cast<long>(hk) * D;
  bf16* ob = o + static_cast<long>(b) * S * q_stride + static_cast<long>(h) * D;

  for (int i = tid; i < BQ * CH; i += TC_NT) {
    const int r = i / CH, c = (i % CH) * 8, s = q0 + r;
    tc::cp_async16(&Qs[r * LD + c], qb + min(s, S - 1) * q_stride + c, s < S);
  }
  const auto load_kv = [&](int kt, int st) {
    for (int i = tid; i < BK * CH; i += TC_NT) {
      const int r = i / CH, c = (i % CH) * 8, s = kt * BK + r;
      const long off = min(s, S - 1) * kv_stride + c;
      tc::cp_async16(&Ks[(st * BK + r) * LD + c], kb + off, s < S);
      tc::cp_async16(&Vs[(st * BK + r) * LD + c], vb + off, s < S);
    }
  };

  int n_tiles = (kv_len + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);
  load_kv(0, 0);
  tc::cp_async_commit();

  const int wq0 = q0 + warp * 16;  // the warp's first query row
  uint32_t qf[D / 16][4];
  float m[2] = {ttsk::NEG_INF, ttsk::NEG_INF};  // rows g and g + 8
  float l[2] = {0.f, 0.f};                      // this lane's part of the rows' sums
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    tc::cp_async_wait<0>();
    __syncthreads();  // tile kt (and Q) landed for all; tile kt-1's stage is free
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        tc::ldmatrix_x4(qf[kk], &Qs[(warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8]);
    }
    if (kt + 1 < n_tiles) {
      load_kv(kt + 1, (kt + 1) & 1);
      tc::cp_async_commit();
    }
    const int k0 = kt * BK;
    const bf16* Kt = Ks + (kt & 1) * BK * LD;
    const bf16* Vt = Vs + (kt & 1) * BK * LD;

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < BK / 16; ++n2) {
        uint32_t r[4];
        tc::ldmatrix_x4(r, &Kt[(n2 * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                               ((lane / 8) % 2) * 8]);
        tc::mma_bf16(s[2 * n2], qf[kk], r[0], r[1]);
        tc::mma_bf16(s[2 * n2 + 1], qf[kk], r[2], r[3]);
      }
    }

    const bool edge = k0 + BK > kv_len || (causal && k0 + BK - 1 > wq0);
    const float scale2 = scale * tc::LOG2E;  // scores, max and exponent in base 2
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale2;
        if (edge) {
          const int kp = k0 + n * 8 + t4 * 2 + (e & 1);
          const int qp = wq0 + g + (e >> 1) * 8;
          x = (kp < kv_len && (!causal || kp <= qp)) ? x : ttsk::NEG_INF;
        }
        s[n][e] = x;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = tc::exp2_fast(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          s[n][e] = tc::exp2_fast(s[n][e] - mx);
          sum += s[n][e];
        }
      l[i] = alpha * l[i] + sum;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * i] *= alpha;
        acc[n][2 * i + 1] *= alpha;
      }
    }

#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t hi[4], lo[4];  // the C fragments of keys 16kc.. as A fragments
      tc::split_bf16(s[2 * kc][0], s[2 * kc][1], hi[0], lo[0]);
      tc::split_bf16(s[2 * kc][2], s[2 * kc][3], hi[1], lo[1]);
      tc::split_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1], hi[2], lo[2]);
      tc::split_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t r[4];
        tc::ldmatrix_x4_trans(r, &Vt[(kc * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD +
                                     n2 * 16 + (lane / 16) * 8]);
        tc::mma_bf16(acc[2 * n2], hi, r[0], r[1]);
        tc::mma_bf16(acc[2 * n2 + 1], hi, r[2], r[3]);
        tc::mma_bf16(acc[2 * n2], lo, r[0], r[1]);
        tc::mma_bf16(acc[2 * n2 + 1], lo, r[2], r[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int qp = wq0 + g + 8 * i;
    if (qp >= S) continue;
    if (lse != nullptr && t4 == 0)  // m is base 2 here: lse = m + log2(sum)
      lse[(static_cast<long>(b) * Hq + h) * S + qp] = m[i] + log2f(sum);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const long idx = (ob - o) + qp * q_stride + n * 8 + t4 * 2;
      const float x = acc[n][2 * i] * inv, y = acc[n][2 * i + 1] * inv;
      if (o_lo != nullptr) {  // O = hi + lo: the residual beside the output
        uint32_t hi, lo;
        tc::split_bf16(x, y, hi, lo);
        *reinterpret_cast<uint32_t*>(&o[idx]) = hi;
        *reinterpret_cast<uint32_t*>(&o_lo[idx]) = lo;
      } else {
        *reinterpret_cast<uint32_t*>(&o[idx]) = tc::pack_bf16(x, y);
      }
    }
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, float* lse,
                      void* o_lo, int B, int S, int Hq, int Hkv, int kv_len, int causal,
                      float scale, cudaStream_t stream) {
  constexpr int smem = TcConfig<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_fwd_tc<D><<<grid, TC_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, static_cast<bf16*>(o_lo), S, Hq, Hkv, kv_len, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores). The bf16 path
// needs 16-byte aligned q, k, v (the wrapper checks). lse: null, or fp32
// [B, Hq, S] for each row's base-2 log-sum-exp. o_lo: null, or (bf16 only)
// [B, S, Hq, D] bf16 for O's rounding residual. Returns cudaGetLastError()
// after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, void* o_lo, int B, int S, int Hq,
                                   int Hkv, int D, int kv_len, int causal, float scale,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (Hkv <= 0 || Hq % Hkv != 0 || kv_len < 1 || kv_len > S || (dtype == 0 && o_lo))
    return cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    return launch_f32<64>(q, k, v, o, l, B, S, Hq, Hkv, kv_len, causal, scale, st);
  if (dtype == 0 && D == 128)
    return launch_f32<128>(q, k, v, o, l, B, S, Hq, Hkv, kv_len, causal, scale, st);
  if (dtype == 1 && D == 64)
    return launch_tc<64>(q, k, v, o, l, o_lo, B, S, Hq, Hkv, kv_len, causal, scale, st);
  if (dtype == 1 && D == 128)
    return launch_tc<128>(q, k, v, o, l, o_lo, B, S, Hq, Hkv, kv_len, causal, scale, st);
  return cudaErrorInvalidValue;
}
