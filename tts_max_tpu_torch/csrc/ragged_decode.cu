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
// What bounds it on the H100: bytes. Each live cache row is read once and
// used for n_rep multiply-adds per element (4 at Llama-3.2-1B), far below
// the card's ~295 operations per byte: the bound is 2 * len * Hkv * D *
// sizeof(cache) bytes over 3.35 TB/s.
//
// The design (not kernel B's split-K): one block of 128 threads per
// (sequence, kv head), grid (B, Hkv), no second pass. The block walks its
// sequence's rows in tiles of BLOCK_K = 128, for ceil(len / 128) tiles; rows
// at or past lengths[b] (or past T) are never loaded, so whatever they hold
// (garbage, NaN) cannot reach the result. In a tile:
//   1. thread i takes row t0 + i: it copies the V row into shared memory
//      (rows padded by 16 bytes, so a quarter-warp's 16-byte stores hit
//      distinct banks) and computes the row's n_rep scores against the
//      scaled query, which sits in shared memory as fp32 [n_rep][D]. Every
//      load of the tile is independent, so all are in flight at once;
//   2. one warp per query row takes the tile's max, turns the scores into
//      probabilities in shared memory and updates that row's running max and
//      sum (the online-softmax state, in shared memory);
//   3. the threads lie along D (two threads a column at D = 64, each for
//      half the query rows) and accumulate P . V from shared memory in
//      registers, after rescaling by the tile's correction factor.
// Plain global loads (no TMA, no tensor cores); a batch of one fills only
// Hkv blocks of 132 SMs, which is why batch-1 synthesis stays on kernel B.
#include "common.cuh"

namespace ttsk {
namespace ragged {

constexpr int BLOCK_K = 128;  // rows per tile, and threads per block
constexpr int NT = BLOCK_K;
constexpr int NWARP = NT / 32;
constexpr int MAX_REP = 8;  // query heads per kv head

// Eight consecutive elements of a row, as fp32 (16- or 32-byte aligned).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The V tile in shared memory: BLOCK_K rows, each padded by 16 bytes.
template <typename T, int D>
struct VTile {
  static constexpr int stride = D + 16 / static_cast<int>(sizeof(T));  // elements
  static constexpr int bytes = BLOCK_K * stride * static_cast<int>(sizeof(T));
};

// Copy one row of D elements (16-byte aligned at both ends) with 16-byte
// loads and stores.
template <typename T, int D>
__device__ __forceinline__ void copy_row(T* dst, const T* src) {
#pragma unroll
  for (int c = 0; c < D * static_cast<int>(sizeof(T)) / 16; ++c)
    reinterpret_cast<uint4*>(dst)[c] = reinterpret_cast<const uint4*>(src)[c];
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
ragged_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
              const int* __restrict__ lengths, T* __restrict__ out, int T_rows, int Hq,
              int Hkv, float scale) {
  constexpr int G = NT / D;          // threads on one column in the P.V phase
  constexpr int RPT = MAX_REP / G;   // query rows a thread accumulates
  constexpr int VS = VTile<T, D>::stride;
  extern __shared__ __align__(16) unsigned char v_raw[];
  T* v_s = reinterpret_cast<T*>(v_raw);  // [BLOCK_K][VS]: the tile's V rows
  __shared__ float q_s[MAX_REP][D];
  __shared__ float p_s[MAX_REP][BLOCK_K];
  __shared__ float m_s[MAX_REP], l_s[MAX_REP], alpha_s[MAX_REP];

  const int b = blockIdx.x, hk = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int n_rep = Hq / Hkv;
  const int len = max(0, min(lengths[b], T_rows));

  for (int i = tid; i < n_rep * D; i += NT) {
    const int r = i / D, d = i % D;
    q_s[r][d] = to_float(q[(static_cast<long>(b) * Hq + hk * n_rep + r) * D + d]) * scale;
  }
  if (tid < MAX_REP) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  const int col = tid % D, g = tid / D;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  __syncthreads();

  const long stride = static_cast<long>(Hkv) * D;  // between rows of one head
  const T* kb = kc + (static_cast<long>(b) * T_rows * Hkv + hk) * D;
  const T* vb = vc + (static_cast<long>(b) * T_rows * Hkv + hk) * D;

  for (int t0 = 0; t0 < len; t0 += BLOCK_K) {
    const int n = min(BLOCK_K, len - t0);
    // 1. row t0 + tid: its V row to shared memory, its scores
    if (tid < n) {
      copy_row<T, D>(v_s + tid * VS, vb + (t0 + tid) * stride);
      float s[MAX_REP];
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) s[r] = 0.f;
      const T* kr = kb + (t0 + tid) * stride;
#pragma unroll
      for (int c = 0; c < D; c += 8) {
        float k8[8];
        load8(kr + c, k8);
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r) {
          if (r < n_rep) {
#pragma unroll
            for (int e = 0; e < 8; ++e) s[r] = fmaf(q_s[r][c + e], k8[e], s[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r)
        if (r < n_rep) p_s[r][tid] = s[r];
    }
    __syncthreads();
    // 2. online-softmax update, one warp per query row
    for (int r = warp; r < n_rep; r += NWARP) {
      float mx = NEG_INF;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, p_s[r][j]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(p_s[r][j] - m_new);
        p_s[r][j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // 3. P . V along D
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = g + i * G;
      if (r < n_rep) acc[i] *= alpha_s[r];
    }
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float v = to_float(v_s[j * VS + col]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = g + i * G;
        if (r < n_rep) acc[i] = fmaf(p_s[r][j], v, acc[i]);
      }
    }
    __syncthreads();  // v_s, p_s and alpha_s are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = g + i * G;
    if (r < n_rep)
      store(&out[(static_cast<long>(b) * Hq + hk * n_rep + r) * D + col],
            acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
                   int B, int T_rows, int Hq, int Hkv, float scale, cudaStream_t stream) {
  constexpr int smem = VTile<T, D>::bytes;
  if (smem > 48 * 1024) {  // fp32 at D = 128: above the default limit
    static const cudaError_t set = cudaFuncSetAttribute(
        ragged_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (set != cudaSuccess) return set;
  }
  ragged_kernel<T, D><<<dim3(B, Hkv), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(out), T_rows, Hq, Hkv, scale);
  return cudaGetLastError();
}

}  // namespace ragged
}  // namespace ttsk

// q [B, Hq, D], k/v [B, T, Hkv, D] and out [B, Hq, D] in one dtype (0
// float32, 1 bfloat16), lengths [B] int32. Returns cudaGetLastError() after
// the launch.
extern "C" int ragged_decode_fwd(const void* q, const void* k, const void* v,
                                 const void* lengths, void* out, int B, int T, int Hq,
                                 int Hkv, int D, float scale, int dtype, void* stream) {
  using namespace ttsk::ragged;
  if (B < 1 || T < 1 || Hkv < 1 || Hq % Hkv != 0 || Hq / Hkv > MAX_REP)
    return cudaErrorInvalidValue;
  const int* lens = static_cast<const int*>(lengths);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch<float, 64>(q, k, v, lens, out, B, T, Hq, Hkv, scale, s);
  if (dtype == 0 && D == 128) return launch<float, 128>(q, k, v, lens, out, B, T, Hq, Hkv, scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, lens, out, B, T, Hq, Hkv, scale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, lens, out, B, T, Hq, Hkv, scale, s);
  return cudaErrorInvalidValue;
}
