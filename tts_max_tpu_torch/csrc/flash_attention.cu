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
// 2 * S^2 * Hq * D multiply-adds (4.3 GFLOP at S=1024, Hq=32, D=64) against
// 3 * S * H * D * 2 bytes of input, some 500 operations per byte, well above
// the card's ~295 operations per byte of bf16 balance.
//
// What the design does about it: nothing clever yet; it is the simple,
// right first version. One block of 256 threads per (q-tile of 64 rows,
// query head, batch). It stages the scaled Q tile and each 64-row K and V
// tile in shared memory as fp32, computes the 64x64 score tile with a 4x4
// register micro-tile per thread on the CUDA cores, keeps the running max,
// sum and a 4 x D/16 slice of the output accumulator in fp32 registers
// (online softmax), and skips every K tile that lies wholly beyond the causal
// diagonal or kv_len. It does not use the tensor cores (no mma/wgmma) and so
// runs at CUDA-core fp32 rates; moving the two products onto wgmma is the
// obvious next step. Masked scores use -1e30 as the Pallas kernel does.
#include "common.cuh"

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
                 const T* __restrict__ v, T* __restrict__ o, int S, int Hq,
                 int Hkv, int kv_len, int causal, float scale) {
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
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int S, int Hq, int Hkv, int kv_len, int causal, float scale,
                   cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, Hq, Hkv, kv_len, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int S, int Hq, int Hkv, int D,
                                   int kv_len, int causal, float scale, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv != 0 || kv_len < 1 || kv_len > S)
    return cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, o, B, S, Hq, Hkv, kv_len, causal, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, o, B, S, Hq, Hkv, kv_len, causal, scale, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, S, Hq, Hkv, kv_len, causal, scale, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, S, Hq, Hkv, kv_len, causal, scale, st);
  return cudaErrorInvalidValue;
}
