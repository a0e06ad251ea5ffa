// Weight-only int8/int4 products at decode shapes: the layer kernels (entry
// kn) and the tied LM head (entry vd).
//
// Replaces: no pallas_call. XLA computes tts_max_tpu/models/quantization.py's
// matmul (:256) and tied_logits (:296), fusing the cast of the int8 or int4
// levels into the product; eager PyTorch would write a bf16 copy of every
// weight on every decode step instead.
//
// What it computes:
//   kn: y[M, N] = x[M, K] @ (levels[K, N] x scale), y in x's dtype, for
//       int8 levels with per-column scales [N], int4 levels (two per byte,
//       low nibble first, two's complement) with per-column scales [N], or
//       int4 levels with grouped scales [K/g, N];
//   vd: logits[M, V] = (h[M, D] . levels[V, D]^T) x scale[V] in fp32, for
//       an int8 or int4 embedding (window).
// Sums are fp32, rounded once to the output dtype.
//
// What bounds it on the H100: bytes. At M <= 16 rows each weight byte is
// used for at most 16 (int8) or 32 (int4) multiply-adds, far below the
// card's ~295 operations per byte: the bound is the levels and scales read
// once over 3.35 TB/s (Llama-3.2-1B's w_gate at int8: 16.8 MB, 5.0 us; the
// tied int8 head window 65542 x 2048: 134 MB, 40 us).
//
// What the design does about it (a first, simple kernel: no tensor cores,
// no TMA):
//   kn: a thread owns one 32-bit word of a K row (4 int8 or 8 int4 columns),
//       so a warp reads 128 consecutive bytes of each row, eight rows ahead.
//       A block of 4 warps stages its slice of x in shared memory as fp32;
//       each warp sums its own run of K rows into fp32 accumulators for
//       every row of x (M templated on 1, 2, 4, 8, 16); a grouped run lies
//       in one group and its sums are multiplied by the group's scale
//       before they are added. The 4 warps add their sums in shared memory
//       and the block writes one fp32 partial; split-K over blocks fills
//       the SMs even for a batch-1 2048 x 512 product. A second kernel adds
//       the partials (8 warps over the splits, each in order, then the warps
//       in order), applies per-column scales and rounds once. Levels become
//       floats by integer ops and one fp32 add, not conversion instructions.
//   vd: a warp per vocab row, 16-byte loads along D, h staged in shared
//       memory as fp32 (padded, so that the float4 reads of 8 lanes hit 8
//       different groups of banks), a shuffle reduction, then x scale[v].
#include "common.cuh"

namespace ttsk {
namespace qmm {

constexpr int WARPS = 4;    // ops/quant_matmul.WARPS
constexpr int UNROLL = 8;   // ops/quant_matmul.UNROLL
constexpr int MAX_RUN = 128;
constexpr int RED_WARPS = 8;  // ops/quant_matmul.RED_WARPS
constexpr int VD_WARPS = 8;  // ops/quant_matmul.VD_WARPS

// Value c of a 32-bit word of BITS-bit two's-complement levels, lowest
// first, exactly: the level plus a bias (128 or 8) is placed in the mantissa
// of 2^23 and the bias subtracted in fp32 (integer ops and one add, where a
// conversion instruction would run at a quarter of the rate).
template <int BITS>
__device__ __forceinline__ float level(uint32_t w, int c) {
  if constexpr (BITS == 8) {
    return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440 | c)) -
           8388736.0f;  // 2^23 + 128
  } else {
    return __uint_as_float(((w >> (4 * c)) & 0xFu) ^ 0x4B000008u) - 8388616.0f;  // 2^23 + 8
  }
}

template <int BITS, int MB, typename T>
__global__ void __launch_bounds__(WARPS * 32)
    kn_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
              const float* __restrict__ gscale, float* __restrict__ part, int M, int K,
              int N, int ldq, int group, int run) {
  constexpr int C = 32 / BITS;  // columns of a word
  __shared__ float xs[MB * WARPS * MAX_RUN];  // x[:, k0:k0+ks] as fp32, [m][kk]
  __shared__ __align__(16) float red[WARPS][32 * C];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ks = WARPS * run;
  const int k0 = blockIdx.y * ks;
  for (int i = threadIdx.x; i < MB * ks; i += WARPS * 32) {
    const int m = i / ks, kk = i - m * ks;
    xs[i] = m < M ? to_float(x[static_cast<size_t>(m) * K + k0 + kk]) : 0.f;
  }
  __syncthreads();

  const int word = blockIdx.x * 32 + lane;
  const bool live = word < (N + C - 1) / C;
  const int kw = k0 + warp * run;  // this warp's first row
  const uint8_t* qp = q + static_cast<size_t>(kw) * ldq + static_cast<size_t>(word) * 4;
  const float* xw = xs + warp * run;
  float acc[MB][C];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[m][c] = 0.f;

  for (int r0 = 0; r0 < run; r0 += UNROLL) {
    uint32_t w[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      w[u] = live ? __ldg(reinterpret_cast<const uint32_t*>(
                        qp + static_cast<size_t>(r0 + u) * ldq))
                  : 0u;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float wf[C];
#pragma unroll
      for (int c = 0; c < C; ++c) wf[c] = level<BITS>(w[u], c);
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const float xv = xw[m * ks + r0 + u];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[m][c] = fmaf(xv, wf[c], acc[m][c]);
      }
    }
  }

  if (group > 0) {  // the run lies in group kw / group: its sums x its scales
    const float* srow = gscale + static_cast<size_t>(kw / group) * N;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int n = word * C + c;
      const float s = live && n < N ? srow[n] : 0.f;
#pragma unroll
      for (int m = 0; m < MB; ++m) acc[m][c] *= s;
    }
  }

  // the 4 warps' sums, added in warp order, one row of x at a time
  const int col0 = blockIdx.x * 32 * C;
  float* out = part + static_cast<size_t>(blockIdx.y) * M * N;
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    if (m < M) {
#pragma unroll
      for (int c = 0; c < C; ++c) red[warp][lane * C + c] = acc[m][c];
      __syncthreads();
      for (int j = threadIdx.x; j < 32 * C; j += WARPS * 32) {
        const int n = col0 + j;
        if (n < N)
          out[static_cast<size_t>(m) * N + n] =
              ((red[0][j] + red[1][j]) + red[2][j]) + red[3][j];
      }
      __syncthreads();
    }
  }
}

// y[m, n] = round(sum_s part[s, m, n] (x scale[n])): a block takes 32
// outputs (one a lane); warp w adds splits w, w + 8, ... in order, and the 8
// warps' sums are added in warp order.
template <typename T>
__global__ void __launch_bounds__(RED_WARPS * 32)
    kn_reduce(const float* __restrict__ part, const float* __restrict__ scale,
              T* __restrict__ y, int splits, int M, int N) {
  __shared__ float sums[RED_WARPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * 32 + lane;
  const bool live = i < M * N;
  const size_t stride = static_cast<size_t>(M) * N;
  float s = 0.f;
  if (live)
    for (int p = warp; p < splits; p += RED_WARPS) s += part[p * stride + i];
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && live) {
    float t = sums[0][lane];
#pragma unroll
    for (int w = 1; w < RED_WARPS; ++w) t += sums[w][lane];
    if (scale != nullptr) t *= scale[i % N];
    store(y + i, t);
  }
}

template <int BITS, int MB, typename T>
cudaError_t launch_kn(const void* x, const void* q, const void* scale, void* part,
                      void* y, int M, int K, int N, int ldq, int group, int run,
                      int splits, int tiles, cudaStream_t stream) {
  kn_kernel<BITS, MB, T><<<dim3(tiles, splits), WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale), static_cast<float*>(part), M, K, N, ldq, group,
      run);
  const int total = M * N;
  kn_reduce<T><<<(total + 31) / 32, RED_WARPS * 32, 0, stream>>>(
      static_cast<const float*>(part), group > 0 ? nullptr : static_cast<const float*>(scale),
      static_cast<T*>(y), splits, M, N);
  return cudaGetLastError();
}

template <int BITS, typename T>
cudaError_t kn_bucket(int mb, const void* x, const void* q, const void* scale, void* part,
                      void* y, int M, int K, int N, int ldq, int group, int run,
                      int splits, int tiles, cudaStream_t stream) {
#define TTSK_KN(B)                                                                    \
  case B:                                                                             \
    return launch_kn<BITS, B, T>(x, q, scale, part, y, M, K, N, ldq, group, run, splits, \
                                 tiles, stream);
  switch (mb) {
    TTSK_KN(1)
    TTSK_KN(2)
    TTSK_KN(4)
    TTSK_KN(8)
    TTSK_KN(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef TTSK_KN
}

// Where element d of a row of h sits in shared memory: 4 floats of padding
// after every 32, so that the float4 reads of 8 lanes of a phase (each lane
// 16 or 32 elements past the last) fall in 8 different groups of banks.
__device__ __forceinline__ int padded(int d) { return d + 4 * (d >> 5); }

template <int BITS, int MB, typename T>
__global__ void __launch_bounds__(VD_WARPS * 32)
    vd_kernel(const T* __restrict__ h, const uint8_t* __restrict__ q,
              const float* __restrict__ scale, float* __restrict__ out, int M, int D,
              int V) {
  extern __shared__ __align__(16) float hs[];  // h as fp32, [MB][padded(D)], rows >= M zero
  const int dp = padded(D);  // D is a multiple of 32
  for (int i = threadIdx.x; i < MB * D; i += VD_WARPS * 32) {
    const int m = i / D, d = i - m * D;
    hs[m * dp + padded(d)] = i < M * D ? to_float(h[i]) : 0.f;
  }
  __syncthreads();

  constexpr int NF = 128 / BITS / 4;  // float4s of h under 16 bytes of levels: 4 or 8
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_bytes = D * BITS / 8;
  for (int v = blockIdx.x * VD_WARPS + warp; v < V; v += gridDim.x * VD_WARPS) {
    const uint8_t* row = q + static_cast<size_t>(v) * row_bytes;
    float acc[MB];
#pragma unroll
    for (int m = 0; m < MB; ++m) acc[m] = 0.f;
#pragma unroll 4
    for (int off = lane * 16; off < row_bytes; off += 512) {
      const uint4 wv = __ldg(reinterpret_cast<const uint4*>(row + off));
      const uint32_t words[4] = {wv.x, wv.y, wv.z, wv.w};
      const int d0 = off * 8 / BITS;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const uint32_t w = words[(f * 4 * BITS) >> 5] >> ((f * 4 * BITS) & 31);
        const float w0 = level<BITS>(w, 0), w1 = level<BITS>(w, 1);
        const float w2 = level<BITS>(w, 2), w3 = level<BITS>(w, 3);
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          const float4 hv =
              *reinterpret_cast<const float4*>(hs + m * dp + padded(d0 + 4 * f));
          acc[m] = fmaf(hv.x, w0, acc[m]);
          acc[m] = fmaf(hv.y, w1, acc[m]);
          acc[m] = fmaf(hv.z, w2, acc[m]);
          acc[m] = fmaf(hv.w, w3, acc[m]);
        }
      }
    }
    float mine = 0.f;
#pragma unroll
    for (int m = 0; m < MB; ++m) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], o);
      if (lane == m) mine = acc[m];
    }
    if (lane < M) out[static_cast<size_t>(lane) * V + v] = mine * scale[v];
  }
}

template <int BITS, int MB, typename T>
cudaError_t launch_vd(const void* h, const void* q, const void* scale, void* out, int M,
                      int D, int V, int blocks, cudaStream_t stream) {
  const int smem = MB * (D + D / 8) * static_cast<int>(sizeof(float));
  static int smem_set = 48 * 1024;  // the most this instantiation was allowed so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        vd_kernel<BITS, MB, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  vd_kernel<BITS, MB, T><<<blocks, VD_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const uint8_t*>(q),
      static_cast<const float*>(scale), static_cast<float*>(out), M, D, V);
  return cudaGetLastError();
}

template <int BITS, typename T>
cudaError_t vd_bucket(int mb, const void* h, const void* q, const void* scale, void* out,
                      int M, int D, int V, int blocks, cudaStream_t stream) {
#define TTSK_VD(B) \
  case B:          \
    return launch_vd<BITS, B, T>(h, q, scale, out, M, D, V, blocks, stream);
  switch (mb) {
    TTSK_VD(1)
    TTSK_VD(2)
    TTSK_VD(4)
    TTSK_VD(8)
    TTSK_VD(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef TTSK_VD
}

}  // namespace qmm
}  // namespace ttsk

// kn: x [M, K] (fp32 x_dtype 0, bf16 1), levels with row stride ldq bytes
// (4-byte aligned), scale [N] or grouped [K/group, N] (group > 0, int4),
// part [splits, M, N] fp32 scratch, y [M, N] in x's dtype. mb, run, splits
// and tiles come from ops/quant_matmul.plan (K = splits * 4 * run, run a
// multiple of 8 dividing group). Returns cudaGetLastError() after the
// launches.
extern "C" int quant_matmul_kn(const void* x, const void* q, const void* scale, void* part,
                               void* y, int M, int K, int N, int ldq, int bits, int group,
                               int mb, int run, int splits, int tiles, int x_dtype,
                               void* stream) {
  using namespace ttsk::qmm;
  if (M < 1 || M > mb || run % UNROLL || run > MAX_RUN || K != splits * WARPS * run ||
      ldq % 4 || (group > 0 && (bits != 4 || group % run)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 8 && x_dtype == 0)
    return kn_bucket<8, float>(mb, x, q, scale, part, y, M, K, N, ldq, group, run, splits, tiles, s);
  if (bits == 8 && x_dtype == 1)
    return kn_bucket<8, __nv_bfloat16>(mb, x, q, scale, part, y, M, K, N, ldq, group, run,
                                       splits, tiles, s);
  if (bits == 4 && x_dtype == 0)
    return kn_bucket<4, float>(mb, x, q, scale, part, y, M, K, N, ldq, group, run, splits, tiles, s);
  if (bits == 4 && x_dtype == 1)
    return kn_bucket<4, __nv_bfloat16>(mb, x, q, scale, part, y, M, K, N, ldq, group, run,
                                       splits, tiles, s);
  return cudaErrorInvalidValue;
}

// vd: h [M, D] (fp32 or bf16, D a multiple of 32), levels [V, D * bits /
// 8] contiguous with 16-byte aligned rows of a multiple of 16 bytes, scale
// [V], out [M, V] fp32. M <= mb; mb * (D + D / 8) * 4 bytes of shared
// memory. Returns
// cudaGetLastError() after the launch.
extern "C" int quant_matmul_vd(const void* h, const void* q, const void* scale, void* out,
                               int M, int D, int V, int bits, int mb, int blocks, int x_dtype,
                               void* stream) {
  using namespace ttsk::qmm;
  if (M < 1 || M > mb || D % 32 || (D * bits / 8) % 16 || blocks < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 8 && x_dtype == 0) return vd_bucket<8, float>(mb, h, q, scale, out, M, D, V, blocks, s);
  if (bits == 8 && x_dtype == 1)
    return vd_bucket<8, __nv_bfloat16>(mb, h, q, scale, out, M, D, V, blocks, s);
  if (bits == 4 && x_dtype == 0) return vd_bucket<4, float>(mb, h, q, scale, out, M, D, V, blocks, s);
  if (bits == 4 && x_dtype == 1)
    return vd_bucket<4, __nv_bfloat16>(mb, h, q, scale, out, M, D, V, blocks, s);
  return cudaErrorInvalidValue;
}
