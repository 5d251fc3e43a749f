// Log-domain Sinkhorn over the [M jobs x N columns] cost matrix, for Hopper
// (sm_90a): one iteration per call (two launches), and the whole annealed
// solve in one launch.
//
// Replaces: repro/kernels/sinkhorn/sinkhorn.py::sinkhorn_iteration_pallas
// (the Pallas TPU kernel) and, for the annealed solve, the loop around it in
// repro/core/round.py::_sinkhorn_pallas. Same update, same order (f from g,
// then g from the new f):
//
//   f_i = eps * (log a_i - LSE_j (g_j - C_ij) / eps)
//   g_j = eps * (log b_j - LSE_i (f_i - C_ij) / eps),  sum clamped at 1e-30
//
// One iteration (sinkhorn_iteration). The TPU grid walked row blocks in
// order and carried the column (max, sum) in VMEM scratch from one block to
// the next. Hopper blocks run in parallel and in no order, so the column
// LSE is combined in a second launch:
//   launch 1 (sinkhorn_rows): one thread per row, ROWS rows a block, g in
//     shared memory. Each thread computes its row's LSE over N and writes
//     f_i; the block then reduces w_ij = (f_i - C_ij) / eps per column into
//     a block (max, sum) with warp shuffles and shared memory, written to
//     pmax / psum [nblocks, N].
//   launch 2 (sinkhorn_cols): one block per column combines the partials
//     in block order and writes g_j.
// No atomics: the reduction order is fixed, so results are identical from
// run to run. eps is a runtime argument.
//
// The annealed solve (sinkhorn_anneal). A round runs `stages` x `iters`
// iterations (6 x 60), eps falling from stage to stage; as 720 launches it
// was bound by host dispatch (~21 ms of wall for ~2.4 ms of device time at
// bucket 512). Here one cooperative launch runs the whole schedule:
//   * ceil(M / ROWS) blocks (64 at M = 16384), all co-resident: the launch
//     checks cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs first and
//     refuses a grid that would not fit;
//   * each block keeps its ROWS rows of C in shared memory, transposed
//     ([N][ROWS], so a thread's row reads are free of bank conflicts), for
//     the whole solve, beside g: C is read from device memory once, not 360
//     times;
//   * each iteration is the row pass above, writing its per-block column
//     partials; one grid-wide sync (cooperative_groups::this_grid().sync());
//     then every block combines all N columns itself, in block order, into
//     its own g in shared memory. The redundant combine saves the second
//     grid sync that "block j combines column j, then every block reloads
//     g" needs; the partials alternate between two buffers, so a block that
//     is an iteration ahead never overwrites what a slower one still reads;
//   * a block's reductions run 8 columns at a time (16 when N > 8): their
//     loads issued together and their shuffle trees interleaved, with one
//     __syncthreads pair per group instead of one per column and
//     reduction (one column at a time, the combine's dependent reads from
//     L2 dominated the iteration), and no shuffle under a condition (each
//     would be a convergence region of its own);
//   * eps comes from a float32 table built on the host, one entry a stage,
//     passed by value.
// The row update is the same device function as the one-iteration
// launches', and the batched reductions keep block_max's and block_sum's
// trees (a warp's xor shuffles, then the warps in order) and the row
// partition, so f and g are bitwise equal to the loop of 360
// sinkhorn_iteration calls (held so on the card). Grid sync needs no
// -rdc=true here: with CUDA 12.9 a cooperative launch of a kernel built
// with the plain `-shared` flags of kernels/_build.py syncs (checked on
// the card).
//
// Bound. The solve must read C once (4 M N bytes) plus O(M + N), and does
// ~12 float32 operations per element per iteration: at M = 512, N = 6 that
// is 13.3 Mop, ~0.2 us at 67 TFLOP/s (float32, H100 SXM data sheet, 700 W).
// The launch is bound by latency instead: 360 grid-wide syncs and the
// block reductions between them, in sequence.
//
// Built without --use_fast_math: at eps = 0.005 the exponent arguments reach
// +-2e6 before masking, and expf/logf/division must stay IEEE-accurate for
// the duals to match the plain version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 256;            // threads (= rows) per block
constexpr int WARPS = ROWS / 32;
constexpr int MAX_STAGES = 32;       // entries of the eps table

struct EpsTable {
  float eps[MAX_STAGES];
};

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

// Row update: f_i from the fixed g (in shared memory). Row i's costs are
// c[j * stride], j < N.
__device__ __forceinline__ float row_update(const float* sg, const float* c,
                                            int stride, float log_a, int N,
                                            float eps) {
  // Unrolled for overlap of the independent loads, divisions and exps;
  // the max and the sum still run in column order.
  float zmax = -INFINITY;
#pragma unroll 8
  for (int j = 0; j < N; ++j)
    zmax = fmaxf(zmax, (sg[j] - c[j * stride]) / eps);
  float s = 0.f;
#pragma unroll 8
  for (int j = 0; j < N; ++j) s += expf((sg[j] - c[j * stride]) / eps - zmax);
  return eps * (log_a - (zmax + logf(s)));
}

// Column partials of LSE_i (f_i - C_ij) / eps over this block's rows,
// written to pmax / psum [blockIdx.x, :]. Every block holds at least one
// live row, so each max is finite.
__device__ __forceinline__ void column_partials(
    float fi, bool live, const float* c, int stride, int N, float eps,
    float* red, float* pmax, float* psum) {
  for (int j = 0; j < N; ++j) {
    const float w = live ? (fi - c[j * stride]) / eps : -INFINITY;
    const float m = block_max(w, red);
    const float s = block_sum(live ? expf(w - m) : 0.f, red);
    if (threadIdx.x == 0) {
      pmax[blockIdx.x * N + j] = m;
      psum[blockIdx.x * N + j] = s;
    }
  }
}

// g_j from the partials of all blocks, combined in block order.
__device__ __forceinline__ float column_combine(
    int j, const float* pmax, const float* psum, float log_b, int nblocks,
    int N, float eps, float* red) {
  float m = -INFINITY;
  for (int b = threadIdx.x; b < nblocks; b += ROWS)
    m = fmaxf(m, pmax[b * N + j]);
  m = block_max(m, red);
  float s = 0.f;
  for (int b = threadIdx.x; b < nblocks; b += ROWS)
    s += psum[b * N + j] * expf(pmax[b * N + j] - m);
  s = block_sum(s, red);
  return eps * (log_b - (m + logf(fmaxf(s, 1e-30f))));
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
  float fi = 0.f;
  if (live) {
    fi = row_update(sg, c, 1, log_a[i], N, eps);
    f[i] = fi;
  }
  column_partials(fi, live, c, 1, N, eps, red, pmax, psum);
}

__global__ void __launch_bounds__(ROWS)
sinkhorn_cols(const float* __restrict__ pmax, const float* __restrict__ psum,
              const float* __restrict__ log_b, float* __restrict__ g_out,
              int nblocks, int N, float eps) {
  __shared__ float red[WARPS];
  const int j = blockIdx.x;
  const float gj = column_combine(j, pmax, psum, log_b[j], nblocks, N, eps,
                                  red);
  if (threadIdx.x == 0) g_out[j] = gj;
}

// The batched reductions of the annealed launch. G columns at a time,
// each column with block_max's / block_sum's tree (a warp's xor shuffles,
// then the warps' results in warp order), but the columns' shuffle trees
// interleaved (independent chains, so they overlap), their loads issued
// together, and one __syncthreads pair per group and reduction instead of
// per column. A group past the last column repeats column N - 1 (computed,
// never stored), so no shuffle sits under a condition. `red` is
// [G][WARPS] and `colm` [G] floats of shared memory; G is 8 for N <= 8,
// else 16.
template <bool MAX, int G>
__device__ __forceinline__ void warp_trees(float (&v)[G],
                                           float (*red)[WARPS]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int jj = 0; jj < G; ++jj) {
      const float u = __shfl_xor_sync(0xffffffffu, v[jj], o);
      v[jj] = MAX ? fmaxf(v[jj], u) : v[jj] + u;
    }
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int jj = 0; jj < G; ++jj) red[jj][threadIdx.x >> 5] = v[jj];
  }
}

// Column jj's warp results, combined in warp order.
template <bool MAX>
__device__ __forceinline__ float warps_in_order(const float (*red)[WARPS],
                                                int jj) {
  float r = red[jj][0];
  for (int w = 1; w < WARPS; ++w)
    r = MAX ? fmaxf(r, red[jj][w]) : r + red[jj][w];
  return r;
}

// column_partials for all N columns, bitwise equal to it.
template <int G>
__device__ __forceinline__ void column_partials_batched(
    float fi, bool live, const float* c, int stride, int N, float eps,
    float (*red)[WARPS], float* colm, float* pmax, float* psum) {
  for (int j0 = 0; j0 < N; j0 += G) {
    const int nc = min(G, N - j0);
    float w[G], v[G];
#pragma unroll
    for (int jj = 0; jj < G; ++jj) {
      const int j = min(j0 + jj, N - 1);
      w[jj] = live ? (fi - c[j * stride]) / eps : -INFINITY;
      v[jj] = w[jj];
    }
    warp_trees<true, G>(v, red);
    __syncthreads();
    if (threadIdx.x < G)
      colm[threadIdx.x] = warps_in_order<true>(red, threadIdx.x);
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < G; ++jj)
      v[jj] = live ? expf(w[jj] - colm[jj]) : 0.f;
    warp_trees<false, G>(v, red);
    __syncthreads();
    if (threadIdx.x < nc) {
      pmax[blockIdx.x * N + j0 + threadIdx.x] = colm[threadIdx.x];
      psum[blockIdx.x * N + j0 + threadIdx.x] =
          warps_in_order<false>(red, threadIdx.x);
    }
    __syncthreads();
  }
}

// column_combine for all N columns into sg, bitwise equal to it. The
// partials were written by other blocks before a grid sync: read past L1.
template <int G>
__device__ __forceinline__ void column_combine_batched(
    const float* pmax, const float* psum, const float* log_b, int nblocks,
    int N, float eps, float (*red)[WARPS], float* colm, float* sg) {
  for (int j0 = 0; j0 < N; j0 += G) {
    const int nc = min(G, N - j0);
    float pm[G], ps[G], v[G];
    if (nblocks <= ROWS) {
      // At most one block's partial per thread: all loads at once.
      const bool has = threadIdx.x < nblocks;
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        const int at = threadIdx.x * N + min(j0 + jj, N - 1);
        pm[jj] = has ? __ldcg(pmax + at) : 0.f;
        ps[jj] = has ? __ldcg(psum + at) : 0.f;
        v[jj] = has ? fmaxf(-INFINITY, pm[jj]) : -INFINITY;
      }
      warp_trees<true, G>(v, red);
      __syncthreads();
      if (threadIdx.x < G)
        colm[threadIdx.x] = warps_in_order<true>(red, threadIdx.x);
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        float sum = 0.f;
        if (has) sum += ps[jj] * expf(pm[jj] - colm[jj]);
        v[jj] = sum;
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        const int j = min(j0 + jj, N - 1);
        float m = -INFINITY;
        for (int b = threadIdx.x; b < nblocks; b += ROWS)
          m = fmaxf(m, __ldcg(pmax + b * N + j));
        v[jj] = m;
      }
      warp_trees<true, G>(v, red);
      __syncthreads();
      if (threadIdx.x < G)
        colm[threadIdx.x] = warps_in_order<true>(red, threadIdx.x);
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        const int j = min(j0 + jj, N - 1);
        float sum = 0.f;
        for (int b = threadIdx.x; b < nblocks; b += ROWS)
          sum += __ldcg(psum + b * N + j) *
                 expf(__ldcg(pmax + b * N + j) - colm[jj]);
        v[jj] = sum;
      }
    }
    warp_trees<false, G>(v, red);
    __syncthreads();
    if (threadIdx.x < nc) {
      const int j = j0 + threadIdx.x;
      sg[j] = eps * (log_b[j] - (colm[threadIdx.x] +
                                 logf(fmaxf(warps_in_order<false>(
                                                red, threadIdx.x),
                                            1e-30f))));
    }
    __syncthreads();
  }
}

// The whole annealed schedule; see the note at the top. Launched
// cooperatively with ceil(M / ROWS) blocks and (N * ROWS + N) floats of
// dynamic shared memory; pmax / psum hold two [nblocks, N] buffers, used
// by turns. G: the columns reduced together.
template <int G>
__global__ void __launch_bounds__(ROWS)
sinkhorn_anneal_kernel(const float* __restrict__ C,
                       const float* __restrict__ log_a,
                       const float* __restrict__ log_b, float* __restrict__ f,
                       float* __restrict__ g, float* __restrict__ pmax,
                       float* __restrict__ psum, int M, int N, int iters,
                       int stages, const EpsTable table) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  extern __shared__ float smem[];
  float* Cs = smem;                  // [N][ROWS], this block's rows
  float* sg = Cs + N * ROWS;         // g, [N]
  __shared__ float red[G][WARPS];
  __shared__ float colm[G];

  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, M - row0);
  const float* Cb = C + static_cast<size_t>(row0) * N;
  for (int e = threadIdx.x; e < rows * N; e += ROWS)
    Cs[(e % N) * ROWS + e / N] = Cb[e];
  for (int j = threadIdx.x; j < N; j += ROWS) sg[j] = 0.f;
  const int i = row0 + threadIdx.x;
  const bool live = i < M;
  const float la = live ? log_a[i] : 0.f;
  // A dead thread's row slot is never written; it reads the block's row 0
  // and masks the value out, as the per-iteration kernel does.
  const float* c = Cs + (live ? threadIdx.x : 0);
  const int nblocks = gridDim.x;
  const size_t half = static_cast<size_t>(nblocks) * N;
  __syncthreads();

  float fi = 0.f;
  int turn = 0;
  for (int s = 0; s < stages; ++s) {
    const float eps = table.eps[s];
    for (int it = 0; it < iters; ++it, turn ^= 1) {
      float* pm = pmax + turn * half;
      float* ps = psum + turn * half;
      if (live) fi = row_update(sg, c, ROWS, la, N, eps);
      column_partials_batched<G>(fi, live, c, ROWS, N, eps, red, colm, pm,
                                 ps);
      grid.sync();
      column_combine_batched<G>(pm, ps, log_b, nblocks, N, eps, red, colm,
                                sg);
    }
  }
  if (live) f[i] = fi;
  if (blockIdx.x == 0)
    for (int j = threadIdx.x; j < N; j += ROWS) g[j] = sg[j];
}

}  // namespace

extern "C" {

// Rows handled by one block of the row launch and of the annealed launch;
// the caller sizes pmax / psum as [ceil(M / ROWS), N].
int sinkhorn_rows_per_block() { return ROWS; }

// Entries the annealed launch's eps table holds.
int sinkhorn_max_stages() { return MAX_STAGES; }

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

// The annealed solve in one cooperative launch: f [M] and g [N] after
// `stages` x `iters` iterations from g = 0, stage s at eps_table[s] (a host
// array of `stages` floats, 1 <= stages <= MAX_STAGES). C, log_a, log_b as
// for sinkhorn_iteration; pmax / psum are scratch of [2, ceil(M / ROWS), N]
// floats. Returns cudaErrorCooperativeLaunchTooLarge when the grid cannot
// be co-resident, else the launch's CUDA error code (0 on success).
int sinkhorn_anneal(const float* C, const float* log_a, const float* log_b,
                    const float* eps_table, int stages, int iters, float* f,
                    float* g, float* pmax, float* psum, int M, int N,
                    cudaStream_t stream) {
  if (stages < 1 || stages > MAX_STAGES || iters < 0 || M < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  EpsTable table;
  for (int s = 0; s < stages; ++s) table.eps[s] = eps_table[s];
  const void* kernel =
      N <= 8 ? reinterpret_cast<const void*>(sinkhorn_anneal_kernel<8>)
             : reinterpret_cast<const void*>(sinkhorn_anneal_kernel<16>);
  const int nblocks = (M + ROWS - 1) / ROWS;
  const size_t smem = sizeof(float) * (static_cast<size_t>(N) * ROWS + N);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, ROWS, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm * sms < nblocks)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&C, &log_a, &log_b, &f, &g, &pmax, &psum, &M, &N,
                  &iters, &stages, &table};
  err = cudaLaunchCooperativeKernel(kernel, dim3(nblocks), dim3(ROWS), args,
                                    smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
