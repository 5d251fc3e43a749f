// Blocked online-softmax attention (flash attention, forward) for Hopper
// (sm_90a) on scalar float32 FMAs: causal, sliding-window or full masks,
// grouped-query heads. It serves float32 inputs, and D 16 and 256; bf16 at
// D 64 and 128 (the LM prefill's path) goes to the tensor-core kernel of
// flash_attention_sm90.cu (kernels/flash_attention/flash_attention.py::
// variant).
//
// Replaces: repro/kernels/flash_attention/flash_attention.py::
// flash_attention_bh (the Pallas TPU kernel, `_kernel`). For each query
// head h and query row i, with kv head h / group:
//
//   o_i = sum_j softmax_j(scale * q_i . k_j + mask_ij) v_j
//
// where mask_ij is 0 where key j is visible to query i (j < Skv; causal:
// j <= i; sliding: also i - j < window) and NEG_INF = -2e38 elsewhere.
//
// Design. The TPU grid walked the kv tiles of one (head, q tile) in order
// and carried the f32 accumulator, running max and running sum in VMEM.
// Here one block owns one (q head, q tile of BQ = 64 rows) and walks the kv
// tiles in a loop inside the block, with m, l and acc in float32 registers:
// 256 threads as a 16 x 16 grid, thread (ty, tx) owning rows ty + 16 i
// (i < 4) and, per kv tile, score columns tx + 16 c and output columns
// tx + 16 k. A row's 16 owners sit in one half-warp, so its max and sum
// are shuffles. Q (scaled, float32) stays in shared memory for the whole
// walk; each kv tile of K (transposed) and V is staged in shared memory as
// float32, the tile's probabilities too. The kv head is bh / group: K and
// V are never repeated in memory. Whole kv tiles are skipped by the TPU
// kernel's liveness rule (flash_attention.py:48-53); the ragged Sq and Skv
// tails are masked here (rows past Sq are computed on zeros and not
// written; keys past Skv are masked like the reference's padding), so any
// Sq and Skv are taken. Transposed tiles have a padded stride (+1) so that
// their stores and loads are free of bank conflicts. A simple kernel:
// scalar float32 FMAs, no tensor cores, no TMA, which keeps float32 inputs
// exact to float32 (the card-vs-CPU parity of float32 serving).
//
// Numbers. The reference's finite NEG_INF is kept: a row whose first live
// tile is fully masked accumulates exp(0) = 1 terms, wiped by
// alpha = exp(-2e38 - m) = 0 when its first visible key arrives (with
// -inf that step is NaN). The output is acc / max(l, 1e-30), as in both
// reference paths. q is scaled in float32 (q * scale after the cast), as
// the Pallas kernel and the model path with the default scale do.
// Built without --use_fast_math (expf, not __expf).
//
// Bound. At qwen2-1.5B prefill (B 4, S 2048, 12 q heads over 2 kv heads,
// D 128, bf16, causal) the two products are 4 * 2 * 48 * 2048^2 * 128 / 2
// = 51.5 GFLOP of the causal triangle, 52 us at the bf16 tensor-core peak
// (989 TFLOP/s); the bytes (q, k, v read once, o written once) are 59 MB,
// 18 us at 3.35 TB/s. The kernel runs on the float32 cores (67 TFLOP/s),
// so it cannot come near that bound; in float32 the same work is 770 us at
// the float32 rate. (Peaks: the H100 SXM data sheet, at its 700 W power
// limit.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int THREADS = 256;   // 16 x 16
constexpr int BQ = 64;         // query rows per block
constexpr int ROWS = BQ / 16;  // rows per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float half_warp_max(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D>
struct Tile {
  static constexpr int BK = D <= 128 ? 64 : 32;  // kv rows per tile
  static constexpr int CPT = BK / 16;            // score columns per thread
  static constexpr int DPT = (D + 15) / 16;      // output columns per thread
  static constexpr int QS = BQ + 1;              // padded strides
  static constexpr int KS = BK + 1;
  static constexpr int PS = BQ + 1;
  static constexpr size_t SMEM =
      sizeof(float) * (size_t(D) * QS + size_t(D) * KS + size_t(BK) * D +
                       size_t(BK) * PS);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
          int group, int causal, int window, float scale) {
  using G = Tile<D>;
  constexpr int BK = G::BK, CPT = G::CPT, DPT = G::DPT;
  constexpr int QS = G::QS, KS = G::KS, PS = G::PS;
  extern __shared__ float smem[];
  float* Qt = smem;              // [D][QS]  q (scaled), transposed
  float* Kt = Qt + D * QS;       // [D][KS]  k tile, transposed
  float* Vs = Kt + D * KS;       // [BK][D]  v tile
  float* Pt = Vs + BK * D;       // [BK][PS] probabilities, transposed

  const int bh = blockIdx.y;
  const int q_first = blockIdx.x * BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* qh = q + static_cast<size_t>(bh) * Sq * D;
  const size_t kv_off = static_cast<size_t>(bh / group) * Skv * D;
  const T* kh = k + kv_off;
  const T* vh = v + kv_off;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D, qp = q_first + r;
    Qt[d * QS + r] =
        qp < Sq ? to_f(qh[static_cast<size_t>(qp) * D + d]) * scale : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DPT];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  const int nk = (Skv + BK - 1) / BK;
  for (int ik = 0; ik < nk; ++ik) {
    const int k_first = ik * BK;
    // Whole-tile liveness, the TPU kernel's rule (uniform over the block).
    if (causal && k_first > q_first + BQ - 1) continue;
    if (window && q_first - (k_first + BK - 1) >= window) continue;

    __syncthreads();   // the previous tile's readers are done (and Qt set)
    for (int e = tid; e < BK * D; e += THREADS) {
      const int j = e / D, d = e % D, kp = k_first + j;
      float kv = 0.f, vv = 0.f;
      if (kp < Skv) {
        const size_t at = static_cast<size_t>(kp) * D + d;
        kv = to_f(kh[at]);
        vv = to_f(vh[at]);
      }
      Kt[d * KS + j] = kv;
      Vs[j * D + d] = vv;
    }
    __syncthreads();

    float s[ROWS][CPT];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[ROWS], kv[CPT];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = Qt[d * QS + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = Kt[d * KS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qp = q_first + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int kp = k_first + tx + 16 * c;
        bool valid = kp < Skv;
        if (causal) valid = valid && kp <= qp;
        if (window) valid = valid && qp - kp < window;
        if (!valid) s[i][c] = NEG_INF;
        mx = fmaxf(mx, s[i][c]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float p = expf(s[i][c] - m_new);
        rs += p;
        Pt[(tx + 16 * c) * PS + ty + 16 * i] = p;
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float pv[ROWS], vv[DPT];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = Pt[j * PS + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int d = tx + 16 * c;
        vv[c] = d < D ? Vs[j * D + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(pv[i], vv[c],
                                                       acc[i][c]);
    }
  }

  T* oh = o + static_cast<size_t>(bh) * Sq * D;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qp = q_first + ty + 16 * i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = tx + 16 * c;
      if (d < D)
        oh[static_cast<size_t>(qp) * D + d] = from_f<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int Sq, int Skv, int group, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = Tile<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_fwd<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, group, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int BH,
             int Sq, int Skv, int D, int group, int causal, int window,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, BH, Sq, Skv, group, causal,
                                  window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, BH, Sq, Skv, group, causal,
                                  window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, BH, Sq, Skv, group, causal,
                                    window, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, BH, Sq, Skv, group, causal,
                                    window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// o [BH, Sq, D] from q [BH, Sq, D] and k, v [BH / group, Skv, D], all
// contiguous on the current device, of one type: dtype 0 float32, 1
// bfloat16. D in {16, 64, 128, 256}. causal and window as in the
// reference (window 0: none). Launches on `stream`; returns the CUDA error
// code (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, int dtype, int BH, int Sq, int Skv, int D,
                        int group, int causal, int window, float scale,
                        cudaStream_t stream) {
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, BH, Sq, Skv, D, group, causal,
                           window, scale, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, BH, Sq, Skv, D, group,
                                   causal, window, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
