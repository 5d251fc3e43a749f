// Mamba-2 chunked SSD scan (state-space duality, forward) for Hopper
// (sm_90a).
//
// Replaces: repro/kernels/ssd_scan/ssd_scan.py::ssd_scan_pallas (the
// Pallas TPU kernel, `_kernel`). For one (b, h) stream, chunk by chunk of L
// rows, with a = dt * A and acs the cumulative sum of a within the chunk:
//
//   y_l   = sum_{s <= l} (C_l . B_s) exp(acs_l - acs_s) dt_s x_s     (intra)
//         + exp(acs_l) C_l . state                                    (inter)
//   state <- exp(acs_{L-1}) state + sum_s exp(acs_{L-1} - acs_s) dt_s x_s B_s^T
//
// with B and C read at group g = h / (H / G), and the state entering the
// first chunk h0 [b, H, P, N] (float32), or zero. Returns y [b, S, H, P] and
// the final state [b, H, P, N] in x's type, and the final state in float32
// where the caller asks for it (the value a context-parallel segment hands
// on). With no y asked for, the block walks the chunks for the state alone
// (the final state from zero of a segment, ssd_scan.py::ssd_final_cuda).
//
// Design. The TPU grid walked the chunks of one (b, h) in order and carried
// the [P, N] state in VMEM. Here one block owns one (b, h) stream and walks
// the chunks in a loop, with the float32 state in shared memory across the
// loop (32 KB at P 64, N 128). B and C are read at their group directly:
// the Pallas wrapper's jnp.repeat over heads (ssd_scan.py:86-89) would cost
// H / G times their bytes. Shared memory does not hold a whole chunk in
// float32 (B and C alone are 256 KB at L 256, N 128), so the chunk's rows
// are tiled by 64: for each row tile of C, the row tiles of B and x * dt up
// to the diagonal are staged in turn, their 64 x 64 scores formed, decayed
// and applied; then the inter-chunk term from the state; then a second
// walk over the chunk's tiles updates the state. 256 threads as a 16 x 16
// grid; thread (ty, tx) owns rows ty + 16 i and columns tx + 16 k of each
// product, so every shared-memory read is a broadcast or a run of
// consecutive words. The cumulative sum is a block scan (warp shuffles).
// Rows past S read as dt = 0 and x = B = C = 0, which is the exact padding
// of models/ssm.py::ssd_chunked, so any S and any chunk length are taken
// (no copies). A simple kernel: scalar float32 FMAs, no tensor cores, no
// TMA.
//
// Numbers. exp(acs_l - acs_s) is only formed for s <= l: for s > l the
// segment sum is positive and grows with the chunk, so exp overflows to
// inf and a 0/1 mask would give inf * 0 = NaN; the select comes first, as
// jnp.where does (ssd_scan.py:48). Built without --use_fast_math.
//
// Bound. At mamba2-2.7B prefill (b 4, S 2048, H 80, P 64, G 1, N 128,
// L 256, bf16 x, B, C) the causal intra-chunk products are
// L^2 (N + P) per (b, h, chunk), the inter term and the state update
// 2 L N P: 2 * 2560 * (256^2 * 192 / 2 + 2 * 256 * 128 * 64) = 53.7 GFLOP
// (86 GFLOP if the masked upper triangle is counted, as the TPU kernel
// computes it), 54 us at the bf16 tensor-core peak; the bytes (x, dt, B, C
// read once, y and the state written once) are 180 MB, 54 us at 3.35 TB/s.
// This kernel runs on the float32 cores (67 TFLOP/s) with 320 blocks on
// 132 SMs, so it cannot come near the bound; wgmma, TMA and more blocks
// per stream are the redesign. (Peaks: the H100 SXM data sheet, at its
// 700 W power limit.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;   // 16 x 16
constexpr int WARPS = THREADS / 32;
constexpr int TL = 64;         // rows of a tile
constexpr int TP = TL + 1;     // padded stride of transposed tiles
constexpr int RPT = TL / 16;   // rows (and score columns) per thread

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

size_t smem_floats(int P, int N, int L) {
  return static_cast<size_t>(N) * P + 2 * static_cast<size_t>(N) * TP +
         static_cast<size_t>(TL) * P + static_cast<size_t>(TL) * TP +
         2 * static_cast<size_t>(L) + WARPS;
}

// PT: output columns per thread (P <= 16 * PT).
template <typename T, int PT>
__global__ void __launch_bounds__(THREADS)
ssd_fwd(const T* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ A, const T* __restrict__ Bm,
        const T* __restrict__ Cm, const float* __restrict__ h0,
        T* __restrict__ y, T* __restrict__ st, float* __restrict__ st32,
        int S, int H, int P, int G, int N, int L) {
  extern __shared__ float smem[];
  float* StT = smem;              // [N][P]   state, n-major
  float* Ct = StT + N * P;        // [N][TP]  C rows of the row tile
  float* Bt = Ct + N * TP;        // [N][TP]  B rows of the column tile
  float* X = Bt + N * TP;         // [TL][P]  x * dt (and the decay, later)
  float* Pt = X + TL * P;         // [TL][TP] decayed scores, transposed
  float* acs = Pt + TL * TP;      // [L]      cumulative a within the chunk
  float* dtc = acs + L;           // [L]      dt of the chunk
  float* wsum = dtc + L;          // [WARPS]  scan scratch

  const int b = blockIdx.x / H, h = blockIdx.x % H, g = h / (H / G);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const float Ah = A[h];
  const size_t xs = static_cast<size_t>(H) * P;    // row stride of x, y
  const size_t bs = static_cast<size_t>(G) * N;    // row stride of B, C
  const T* xb = x + static_cast<size_t>(b) * S * xs + static_cast<size_t>(h) * P;
  T* yb = y + static_cast<size_t>(b) * S * xs + static_cast<size_t>(h) * P;
  const float* dtb = dt + static_cast<size_t>(b) * S * H + h;
  const T* Bb = Bm + static_cast<size_t>(b) * S * bs + static_cast<size_t>(g) * N;
  const T* Cb = Cm + static_cast<size_t>(b) * S * bs + static_cast<size_t>(g) * N;

  const float* h0b =
      h0 != nullptr ? h0 + static_cast<size_t>(blockIdx.x) * P * N : nullptr;
  for (int e = tid; e < N * P; e += THREADS)
    StT[e] = h0b != nullptr ? h0b[(e % P) * N + e / P] : 0.f;

  const int nc = (S + L - 1) / L;
  const int nt = (L + TL - 1) / TL;
  for (int c = 0; c < nc; ++c) {
    const int cs = c * L;
    // A row of the chunk is real if it lies in the chunk and before S.
    auto real = [&](int l) { return l < L && cs + l < S; };

    // dt of the chunk and the inclusive cumulative sum of a = dt * A.
    float carry = 0.f;
    for (int base = 0; base < L; base += THREADS) {
      const int l = base + tid;
      const float dv = real(l) ? dtb[static_cast<size_t>(cs + l) * H] : 0.f;
      if (l < L) dtc[l] = dv;
      float v = dv * Ah;
      for (int off = 1; off < 32; off <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += n;
      }
      __syncthreads();   // wsum's previous readers are done
      if (lane == 31) wsum[warp] = v;
      __syncthreads();
      if (warp == 0) {
        float t = lane < WARPS ? wsum[lane] : 0.f;
        for (int off = 1; off < WARPS; off <<= 1) {
          const float n = __shfl_up_sync(0xffffffffu, t, off);
          if (lane >= off) t += n;
        }
        if (lane < WARPS) wsum[lane] = t;
      }
      __syncthreads();
      if (l < L) acs[l] = carry + (warp > 0 ? wsum[warp - 1] : 0.f) + v;
      carry += wsum[WARPS - 1];
    }
    __syncthreads();

    // y for each row tile: intra-chunk dual form, then the inter term.
    for (int lt = 0; y != nullptr && lt < nt; ++lt) {
      const int l0 = lt * TL;
      for (int e = tid; e < TL * N; e += THREADS) {
        const int r = e / N, n = e % N, l = l0 + r;
        Ct[n * TP + r] =
            real(l) ? to_f(Cb[static_cast<size_t>(cs + l) * bs + n]) : 0.f;
      }
      float acc[RPT][PT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int k = 0; k < PT; ++k) acc[i][k] = 0.f;

      for (int ct = 0; ct <= lt; ++ct) {
        const int s0 = ct * TL;
        __syncthreads();   // the previous tile's readers are done
        for (int e = tid; e < TL * N; e += THREADS) {
          const int j = e / N, n = e % N, s = s0 + j;
          Bt[n * TP + j] =
              real(s) ? to_f(Bb[static_cast<size_t>(cs + s) * bs + n]) : 0.f;
        }
        for (int e = tid; e < TL * P; e += THREADS) {
          const int j = e / P, p = e % P, s = s0 + j;
          X[j * P + p] = real(s)
              ? to_f(xb[static_cast<size_t>(cs + s) * xs + p]) * dtc[s] : 0.f;
        }
        __syncthreads();

        float sc[RPT][RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < RPT; ++j) sc[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[RPT], bv[RPT];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            cv[i] = Ct[n * TP + ty + 16 * i];
            bv[i] = Bt[n * TP + tx + 16 * i];
          }
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < RPT; ++j) sc[i][j] = fmaf(cv[i], bv[j],
                                                          sc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int l = l0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < RPT; ++j) {
            const int s = s0 + tx + 16 * j;
            // Select before the exp: for s > l the exponent is positive.
            const float w = (s <= l && l < L)
                ? sc[i][j] * expf(acs[l] - acs[s]) : 0.f;
            Pt[(tx + 16 * j) * TP + ty + 16 * i] = w;
          }
        }
        __syncthreads();

        for (int j = 0; j < TL; ++j) {
          float pv[RPT], xv[PT];
#pragma unroll
          for (int i = 0; i < RPT; ++i) pv[i] = Pt[j * TP + ty + 16 * i];
#pragma unroll
          for (int k = 0; k < PT; ++k) {
            const int p = tx + 16 * k;
            xv[k] = p < P ? X[j * P + p] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int k = 0; k < PT; ++k) acc[i][k] = fmaf(pv[i], xv[k],
                                                          acc[i][k]);
        }
      }

      // The carried state is zero before the first chunk unless h0 is
      // given.
      if (c > 0 || h0 != nullptr) {
        float in[RPT][PT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int k = 0; k < PT; ++k) in[i][k] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[RPT], sv[PT];
#pragma unroll
          for (int i = 0; i < RPT; ++i) cv[i] = Ct[n * TP + ty + 16 * i];
#pragma unroll
          for (int k = 0; k < PT; ++k) {
            const int p = tx + 16 * k;
            sv[k] = p < P ? StT[n * P + p] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int k = 0; k < PT; ++k) in[i][k] = fmaf(cv[i], sv[k],
                                                         in[i][k]);
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int l = l0 + ty + 16 * i;
          const float e = l < L ? expf(acs[l]) : 0.f;
#pragma unroll
          for (int k = 0; k < PT; ++k) acc[i][k] += e * in[i][k];
        }
      }

#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int l = l0 + ty + 16 * i;
        if (!real(l)) continue;
#pragma unroll
        for (int k = 0; k < PT; ++k) {
          const int p = tx + 16 * k;
          if (p < P)
            yb[static_cast<size_t>(cs + l) * xs + p] = from_f<T>(acc[i][k]);
        }
      }
      __syncthreads();   // Ct's readers are done before the next row tile
    }

    // State update: decay the old state, inject this chunk. Thread
    // (ty, tx) owns state rows n0 + ty + 16 i and columns tx + 16 k.
    const float acs_last = acs[L - 1];
    const float decay_all = expf(acs_last);
    for (int n0 = 0; n0 < N; n0 += TL)
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int n = n0 + ty + 16 * i;
#pragma unroll
        for (int k = 0; k < PT; ++k) {
          const int p = tx + 16 * k;
          if (n < N && p < P) StT[n * P + p] *= decay_all;
        }
      }
    for (int ct = 0; ct < nt; ++ct) {
      const int s0 = ct * TL;
      __syncthreads();
      for (int e = tid; e < TL * N; e += THREADS) {
        const int j = e / N, n = e % N, s = s0 + j;
        Bt[n * TP + j] =
            real(s) ? to_f(Bb[static_cast<size_t>(cs + s) * bs + n]) : 0.f;
      }
      for (int e = tid; e < TL * P; e += THREADS) {
        const int j = e / P, p = e % P, s = s0 + j;
        X[j * P + p] = real(s)
            ? to_f(xb[static_cast<size_t>(cs + s) * xs + p]) * dtc[s]
                  * expf(acs_last - acs[s])
            : 0.f;
      }
      __syncthreads();
      for (int n0 = 0; n0 < N; n0 += TL) {
        float u[RPT][PT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int k = 0; k < PT; ++k) u[i][k] = 0.f;
        for (int j = 0; j < TL; ++j) {
          float bv[RPT], xv[PT];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int n = n0 + ty + 16 * i;
            bv[i] = n < N ? Bt[n * TP + j] : 0.f;
          }
#pragma unroll
          for (int k = 0; k < PT; ++k) {
            const int p = tx + 16 * k;
            xv[k] = p < P ? X[j * P + p] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int k = 0; k < PT; ++k) u[i][k] = fmaf(bv[i], xv[k],
                                                        u[i][k]);
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int n = n0 + ty + 16 * i;
#pragma unroll
          for (int k = 0; k < PT; ++k) {
            const int p = tx + 16 * k;
            if (n < N && p < P) StT[n * P + p] += u[i][k];
          }
        }
      }
    }
    __syncthreads();   // the state is complete before the next chunk
  }

  const size_t out = static_cast<size_t>(blockIdx.x) * P * N;
  for (int e = tid; e < P * N; e += THREADS) {
    const float v = StT[(e % N) * P + e / N];
    if (st != nullptr) st[out + e] = from_f<T>(v);
    if (st32 != nullptr) st32[out + e] = v;
  }
}

template <typename T, int PT>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, const float* h0, void* y, void* st, float* st32,
           int b, int S, int H, int P, int G, int N, int L,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(P, N, L);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<T, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_fwd<T, PT><<<b * H, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B),
      static_cast<const T*>(C), h0, static_cast<T*>(y), static_cast<T*>(st),
      st32, S, H, P, G, N, L);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const float* dt, const float* A, const void* B,
             const void* C, const float* h0, void* y, void* st, float* st32,
             int b, int S, int H, int P, int G, int N, int L,
             cudaStream_t stream) {
  if (P <= 16)
    return launch<T, 1>(x, dt, A, B, C, h0, y, st, st32, b, S, H, P, G, N, L,
                        stream);
  if (P <= 32)
    return launch<T, 2>(x, dt, A, B, C, h0, y, st, st32, b, S, H, P, G, N, L,
                        stream);
  if (P <= 64)
    return launch<T, 4>(x, dt, A, B, C, h0, y, st, st32, b, S, H, P, G, N, L,
                        stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs at (P, N, L); the caller
// checks it against the card's limit before launching.
long long ssd_scan_smem_bytes(int P, int N, int L) {
  return static_cast<long long>(sizeof(float) * smem_floats(P, N, L));
}

// y [b, S, H, P] and the final state [b, H, P, N] from x [b, S, H, P],
// dt [b, S, H] (float32), A [H] (float32), B, C [b, S, G, N] and the state
// entering the first chunk h0 [b, H, P, N] (float32; null: zero); x, B, C,
// y and st of one type (dtype 0 float32, 1 bfloat16), st32 the final state
// in float32; all contiguous on the current device. y, st and st32 may each
// be null (not written; with y null no output is formed). P <= 64, G
// divides H, chunk length L >= 1. Launches on `stream`; returns the CUDA
// error code (0 on success).
int ssd_scan_fwd(const void* x, const float* dt, const float* A,
                 const void* B, const void* C, const float* h0, void* y,
                 void* st, float* st32, int dtype, int b, int S, int H, int P,
                 int G, int N, int L, cudaStream_t stream) {
  if (dtype == 0)
    return dispatch<float>(x, dt, A, B, C, h0, y, st, st32, b, S, H, P, G, N,
                           L, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, dt, A, B, C, h0, y, st, st32, b, S, H,
                                   P, G, N, L, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
