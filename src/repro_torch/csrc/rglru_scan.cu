// The RG-LRU diagonal linear recurrence over [B, S, W], forward and
// backward, for Hopper (sm_90a).
//
// Replaces: repro/kernels/rglru_scan/rglru_scan.py::rglru_scan_pallas (the
// Pallas TPU kernel) and its custom VJP, repro/kernels/rglru_scan/ops.py::
// _scan_bwd, which runs that kernel once more on reversed time:
//
//   forward   y_t = a_t * y_{t-1} + bx_t,             y_{-1} = 0
//   backward  g_t = gy_t + a_{t+1} * g_{t+1},         g_S = 0
//             da_t = g_t * y_{t-1},  dbx_t = g_t      (y_{-1} = 0)
//
// Design. The TPU grid walked time chunks in order and carried h in VMEM
// from one chunk to the next. Hopper blocks run in parallel and in no
// order, so nothing is carried across blocks: one thread owns one (b, w)
// lane and walks all of S with h in a register. Neighbouring threads take
// neighbouring w, so each time step's loads and stores coalesce over W.
// Any B, S and W are taken; the ragged edge of the last block is masked.
// The backward is its own kernel, a reverse walk that reads a_{t+1} (kept
// in a register from the previous step) and writes da and dbx in the same
// pass: one launch, no flipped or shifted copies.
//
// Bound. The forward must read a and bx and write y (3 * B*S*W * 4 bytes),
// the backward read a, gy and y and write da and dbx (5 * B*S*W * 4 bytes):
// at the learned forecaster's training shape [64, 48, 16] that is 0.59 MB
// and 0.98 MB, 0.18 us and 0.29 us at 3.35 TB/s. Two float operations per
// element make the operation bound smaller still. At these sizes a launch
// costs far more than either bound; the kernel is kept simple on purpose.
//
// Numbers. Built without --use_fast_math. The recurrence step is an
// explicit fmaf (one rounding) where the plain PyTorch version multiplies
// and adds (two roundings), so the two differ in the last bits of each
// step; the comparisons hold them to an absolute 1e-4.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;          // lanes per block

__global__ void __launch_bounds__(THREADS)
rglru_fwd(const float* __restrict__ a, const float* __restrict__ bx,
          float* __restrict__ y, int B, int S, int W) {
  const long long lane = static_cast<long long>(blockIdx.x) * THREADS
                         + threadIdx.x;
  if (lane >= static_cast<long long>(B) * W) return;
  const long long b = lane / W, w = lane % W;
  const long long stride = W;
  long long i = b * S * stride + w;
  float h = 0.f;
  for (int t = 0; t < S; ++t, i += stride) {
    h = fmaf(a[i], h, bx[i]);
    y[i] = h;
  }
}

__global__ void __launch_bounds__(THREADS)
rglru_bwd(const float* __restrict__ a, const float* __restrict__ y,
          const float* __restrict__ gy, float* __restrict__ da,
          float* __restrict__ dbx, int B, int S, int W) {
  const long long lane = static_cast<long long>(blockIdx.x) * THREADS
                         + threadIdx.x;
  if (lane >= static_cast<long long>(B) * W) return;
  const long long b = lane / W, w = lane % W;
  const long long stride = W;
  long long i = b * S * stride + w + static_cast<long long>(S - 1) * stride;
  float g = 0.f;
  float a_next = 0.f;                 // a_{t+1}; the final gate never enters
  for (int t = S - 1; t >= 0; --t, i -= stride) {
    g = fmaf(a_next, g, gy[i]);
    dbx[i] = g;
    da[i] = t > 0 ? g * y[i - stride] : 0.f;
    a_next = a[i];
  }
}

int blocks_for(int B, int W) {
  const long long lanes = static_cast<long long>(B) * W;
  return static_cast<int>((lanes + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" {

// y [B, S, W] from a and bx [B, S, W]; all float32, contiguous, on the
// current device. Launches on `stream`; returns cudaGetLastError().
int rglru_scan_fwd(const float* a, const float* bx, float* y, int B, int S,
                   int W, cudaStream_t stream) {
  rglru_fwd<<<blocks_for(B, W), THREADS, 0, stream>>>(a, bx, y, B, S, W);
  return static_cast<int>(cudaGetLastError());
}

// da and dbx [B, S, W] from a, the forward's y and the cotangent gy, all
// [B, S, W] float32, contiguous. Launches on `stream`; returns
// cudaGetLastError().
int rglru_scan_bwd(const float* a, const float* y, const float* gy,
                   float* da, float* dbx, int B, int S, int W,
                   cudaStream_t stream) {
  rglru_bwd<<<blocks_for(B, W), THREADS, 0, stream>>>(a, y, gy, da, dbx, B,
                                                      S, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
