// One log-domain Sinkhorn iteration over the [M jobs x N columns] cost
// matrix, for Hopper (sm_90a).
//
// Replaces: repro/kernels/sinkhorn/sinkhorn.py::sinkhorn_iteration_pallas
// (the Pallas TPU kernel). Same update, same order (f from g, then g from
// the new f):
//
//   f_i = eps * (log a_i - LSE_j (g_j - C_ij) / eps)
//   g_j = eps * (log b_j - LSE_i (f_i - C_ij) / eps),  sum clamped at 1e-30
//
// Design. The TPU grid walked row blocks in order and carried the column
// (max, sum) in VMEM scratch from one block to the next. Hopper blocks run
// in parallel and in no order, so the column LSE is combined in a second
// launch instead:
//   launch 1 (sinkhorn_rows): one thread per row, ROWS rows a block, g in
//     shared memory. Each thread computes its row's LSE over N and writes
//     f_i; the block then reduces w_ij = (f_i - C_ij) / eps per column into
//     a block (max, sum) with warp shuffles and shared memory, written to
//     pmax / psum [nblocks, N].
//   launch 2 (sinkhorn_cols): one block per column combines the partials
//     and writes g_j.
// No atomics: the reduction order is fixed, so results are identical from
// run to run. eps is a runtime argument (one build serves every stage of
// the annealed schedule).
//
// Bound. Each iteration must read C once (4*M*N bytes) plus O(M + N): at
// M = 16384, N = 6 about 0.5 MB, ~0.16 us at 3.35 TB/s. At the scheduler's
// sizes the kernel is bound by launch latency, not memory: a round makes
// 360 iterations = 720 launches. One persistent launch for the whole
// annealed schedule (or a CUDA graph per bucket) is the later fix.
//
// Built without --use_fast_math: at eps = 0.005 the exponent arguments reach
// +-2e6 before masking, and expf/logf/division must stay IEEE-accurate for
// the duals to match the plain version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 256;            // threads (= rows) per block
constexpr int WARPS = ROWS / 32;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide reductions; every thread gets the result. `red` holds WARPS
// floats of shared memory and is free again when the call returns.
__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < WARPS; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < WARPS; ++w) r += red[w];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(ROWS)
sinkhorn_rows(const float* __restrict__ C, const float* __restrict__ g,
              const float* __restrict__ log_a, float* __restrict__ f,
              float* __restrict__ pmax, float* __restrict__ psum, int M,
              int N, float eps) {
  extern __shared__ float sg[];      // g, [N]
  __shared__ float red[WARPS];
  for (int j = threadIdx.x; j < N; j += ROWS) sg[j] = g[j];
  __syncthreads();

  const int i = blockIdx.x * ROWS + threadIdx.x;
  const bool live = i < M;
  const float* c = C + static_cast<size_t>(live ? i : 0) * N;

  // Row update: f_i from the fixed g.
  float fi = 0.f;
  if (live) {
    float zmax = -INFINITY;
    for (int j = 0; j < N; ++j) zmax = fmaxf(zmax, (sg[j] - c[j]) / eps);
    float s = 0.f;
    for (int j = 0; j < N; ++j) s += expf((sg[j] - c[j]) / eps - zmax);
    fi = eps * (log_a[i] - (zmax + logf(s)));
    f[i] = fi;
  }

  // Column partials of LSE_i (f_i - C_ij) / eps over this block's rows.
  // Every block holds at least one live row, so m is finite.
  for (int j = 0; j < N; ++j) {
    const float w = live ? (fi - c[j]) / eps : -INFINITY;
    const float m = block_max(w, red);
    const float s = block_sum(live ? expf(w - m) : 0.f, red);
    if (threadIdx.x == 0) {
      pmax[blockIdx.x * N + j] = m;
      psum[blockIdx.x * N + j] = s;
    }
  }
}

__global__ void __launch_bounds__(ROWS)
sinkhorn_cols(const float* __restrict__ pmax, const float* __restrict__ psum,
              const float* __restrict__ log_b, float* __restrict__ g_out,
              int nblocks, int N, float eps) {
  __shared__ float red[WARPS];
  const int j = blockIdx.x;
  float m = -INFINITY;
  for (int b = threadIdx.x; b < nblocks; b += ROWS)
    m = fmaxf(m, pmax[b * N + j]);
  m = block_max(m, red);
  float s = 0.f;
  for (int b = threadIdx.x; b < nblocks; b += ROWS)
    s += psum[b * N + j] * expf(pmax[b * N + j] - m);
  s = block_sum(s, red);
  if (threadIdx.x == 0)
    g_out[j] = eps * (log_b[j] - (m + logf(fmaxf(s, 1e-30f))));
}

}  // namespace

extern "C" {

// Rows handled by one block of the row launch; the caller sizes pmax / psum
// as [ceil(M / ROWS), N].
int sinkhorn_rows_per_block() { return ROWS; }

// One iteration: f [M] and g_out [N] from C [M, N], g [N], log_a [M],
// log_b [N]. All float32, contiguous, on the current device; pmax / psum are
// scratch of [ceil(M / ROWS), N] floats. Launches on `stream` and returns
// cudaGetLastError() after each launch (0 on success).
int sinkhorn_iteration(const float* C, const float* g, const float* log_a,
                       const float* log_b, float* f, float* g_out,
                       float* pmax, float* psum, int M, int N, float eps,
                       cudaStream_t stream) {
  const int nblocks = (M + ROWS - 1) / ROWS;
  sinkhorn_rows<<<nblocks, ROWS, N * sizeof(float), stream>>>(
      C, g, log_a, f, pmax, psum, M, N, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sinkhorn_cols<<<N, ROWS, 0, stream>>>(pmax, psum, log_b, g_out, nblocks,
                                        N, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
