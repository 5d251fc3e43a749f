// The RG-LRU recurrence of Griffin's recurrent block for Hopper (sm_90a):
// the gate math, the linear recurrence and, backward, every gradient, in
// one launch each way; and, from the same templates with the gate stage
// off, the scan alone over precomputed gates.
//
// Replaces: repro/kernels/rglru_scan/rglru_scan.py::rglru_scan_pallas (the
// Pallas TPU kernel) and its custom VJP's backward, repro/kernels/
// rglru_scan/ops.py::_scan_bwd (the same kernel on reversed time), and the
// gate math around them, repro/models/rglru.py::_gates, which XLA fuses on
// the TPU and which eager PyTorch would run as a dozen launches.
//
// Function (the fused layer). From pre_r = x W_a + b_a, pre_i = x W_x + b_x
// and x, all [B, S, W], and lam [W], float32 (the two gate products stay
// matmuls outside, as the TPU kernel keeps them):
//
//   r = sigmoid(pre_r),  i = sigmoid(pre_i)
//   log_a = (-8 softplus(lam)) r     softplus = logaddexp(lam, 0)
//   a = exp(log_a),  bx = sqrt(max(1 - exp(2 log_a), 1e-12)) (i x)
//   y_t = a_t y_{t-1} + bx_t,  y_{-1} = 0
//
// Backward, from the saved inputs, the forward's y and the cotangent gy:
// r, i, a and the sqrt factor are recomputed, the reverse recurrence
//   g_t = gy_t + a_{t+1} g_{t+1},  g_S = 0
// gives da_t = g_t y_{t-1} and dbx_t = g_t, and the chain rule through the
// gate math, in the order autograd takes it through the plain version
// (kernels/rglru_scan/ref.py), gives d_pre_r, d_pre_i, d_x and d_lam. Where
// 1 - exp(2 log_a) < 1e-12 the sqrt factor's gradient is 0, as torch.clamp
// gives it. d_lam sums over B x S without float atomics: each block writes
// its partial, and the last block to finish (an integer ticket) sums them
// in a fixed order, so the result is the same on every run.
//
// Design. The old kernel gave one thread one (b, w) lane and walked all of
// S, loading inside the dependent chain. Here a block owns one batch row
// and TW = 16 or 32 consecutive lanes, and walks S in tiles of TS = NC * L
// steps, NC = 8 chunks of L steps:
//   1. the tile's slabs of every input are staged into shared memory by
//      cp.async (16-byte copies where W % 4 == 0 and the arrays are
//      16-byte aligned, else 4-byte copies), all in flight at once; with
//      more than one tile the next tile's copies fly while this one runs;
//   2. the gate math runs element-parallel over the whole slab;
//   3. thread (chunk c, lane w) scans its L steps from zero, keeping
//      (prod a, local end); the pairs combine across the chunks before it
//      with the associative combine of repro/models/rglru.py:70-73,
//      (P, h) o carry = P carry + h, folded onto the tile's carry; then it
//      rescans its chunk from the carried state and stores. The last
//      chunk's end is the next tile's carry, kept on chip.
// The dependent chain is L + (NC - 1) + L steps a tile: 6 + 7 + 6 at the
// learned forecaster's S = 48 (L = ceil(S / 8) for S <= 128, one tile),
// against 48 for one thread a lane. At [4, 2048, 2560] (griffin's
// lru_width) L = 8 and a block walks 32 tiles, 320 blocks over 132 SMs.
// The backward walks the tiles in reverse with the same three steps on
// g, a_{t+1} taken from the next row (the first row of the later tile,
// kept on chip). Any B, S and W are taken: rows past S and lanes past W
// read as zero and are never stored; the reverse scan meets them before
// the live rows, where gy = 0 keeps g at 0.
//
// Bound. The fused forward reads pre_r, pre_i, x and writes y (4 arrays of
// B*S*W float32, plus lam); the backward reads pre_r, pre_i, x, y, gy and
// writes d_pre_r, d_pre_i, d_x (8 arrays). At the forecaster's training
// shape [64, 48, 16] that is 0.79 MB and 1.57 MB, 0.23 and 0.47 us at
// 3.35 TB/s, far below a launch; the chunked chain and the one launch in
// place of a dozen are what the design buys there. At [4, 2048, 2560] the
// scan alone moves 252 MB (a, bx in, y out), 75 us: bytes bound, so the
// staging keeps enough copies in flight to stream. (Peaks: the H100 SXM
// data sheet, at its 700 W power limit.)
//
// Numbers. Built without --use_fast_math: expf, log1pf and sqrtf are the
// IEEE-faithful library versions. The recurrence steps are fmaf (one
// rounding) where the plain version multiplies and adds, and the chunk
// carries are formed by the combine, not step by step; the comparisons
// hold the kernels to an absolute 1e-4 (gradients at the clamp, all tiny:
// relative to their largest element, chip_smoke.py).

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int NC = 8;                 // chunks a tile (threads a lane)
constexpr int MAX_L = 16;             // steps a chunk
constexpr float GRIFFIN_C = 8.f;      // Griffin's fixed constant
constexpr float SQRT_FLOOR = 1e-12f;

__device__ __forceinline__ float sigmoid_(float v) {
  return 1.f / (1.f + expf(-v));
}

// logaddexp(v, 0), as torch computes it: max + log1p(exp(min - max)).
__device__ __forceinline__ float softplus_(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

struct Shape {
  int B, S, W, L;
  int vec;                            // 16-byte copies
};

// Issue the copies of rows [t_first, t_first + rows) of lanes
// [w0, w0 + TW) of one batch row (element offset `base`) into dst
// [rows][TW]. Rows outside [0, S) and lanes >= W are zero-filled.
template <int TW>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long base, int t_first, int rows,
                                      int w0, const Shape& s) {
  if (s.vec) {
    constexpr int Q = TW / 4;
    for (int e = threadIdx.x; e < rows * Q; e += TW * NC) {
      const int r = e / Q, q = e % Q;
      const int t = t_first + r, w = w0 + 4 * q;
      const bool ok = t >= 0 && t < s.S && w < s.W;
      cp_async16(dst + r * TW + 4 * q,
                 ok ? src + base + static_cast<long long>(t) * s.W + w : src,
                 ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * TW; e += TW * NC) {
      const int r = e / TW, q = e % TW;
      const int t = t_first + r, w = w0 + q;
      const bool ok = t >= 0 && t < s.S && w < s.W;
      cp_async4(dst + e,
                ok ? src + base + static_cast<long long>(t) * s.W + w : src,
                ok);
    }
  }
}

struct FwdArgs {
  const float* u0;                    // pre_r (fused) or a (scan)
  const float* u1;                    // pre_i (fused) or bx (scan)
  const float* x;                     // fused only
  const float* lam;                   // fused only
  float* y;
  Shape s;
};

struct BwdArgs {
  const float* u0;                    // pre_r (fused) or a (scan)
  const float* pre_i;                 // fused only
  const float* x;                     // fused only
  const float* lam;                   // fused only
  const float* y;
  const float* gy;
  float* d0;                          // d_pre_r (fused) or da (scan)
  float* d1;                          // d_pre_i (fused) or dbx (scan)
  float* dx;                          // fused only
  float* dlam;                        // fused only: [W]
  float* partial;                     // fused only: [B, W]
  unsigned* ticket;                   // fused only: 0 at entry, 0 at exit
  Shape s;
};

template <bool GATES>
__host__ __device__ constexpr int fwd_inputs() { return GATES ? 3 : 2; }
template <bool GATES>                 // + y, staged apart
__host__ __device__ constexpr int bwd_inputs() { return GATES ? 4 : 2; }

__host__ __device__ inline int tiles(const Shape& s) {
  const int ts = NC * s.L;
  return (s.S + ts - 1) / ts;
}

// Shared memory of a launch, in floats: the staged slabs (two stages when
// there is more than one tile), then the block's own arrays.
template <bool GATES, int TW>
__host__ __device__ inline int fwd_smem_floats(const Shape& s) {
  const int slab = NC * s.L * TW;
  const int stages = tiles(s) > 1 ? 2 : 1;
  return stages * fwd_inputs<GATES>() * slab + 2 * NC * TW + TW;
}

template <bool GATES, int TW>
__host__ __device__ inline int bwd_stage_floats(const Shape& s) {
  const int slab = NC * s.L * TW;
  return bwd_inputs<GATES>() * slab + slab + TW;       // + y from t0 - 1
}

template <bool GATES, int TW>
__host__ __device__ inline int bwd_smem_floats(const Shape& s) {
  const int slab = NC * s.L * TW;
  const int stages = tiles(s) > 1 ? 2 : 1;
  return stages * bwd_stage_floats<GATES, TW>(s) + (slab + TW)
         + 3 * NC * TW + TW;
}

template <bool GATES, int TW>
__global__ void __launch_bounds__(TW * NC) rglru_fwd_kernel(const FwdArgs p) {
  constexpr int NIN = fwd_inputs<GATES>();
  constexpr int THREADS = TW * NC;
  const Shape& s = p.s;
  const int L = s.L, TS = NC * L, slab = TS * TW;
  const int ntiles = tiles(s);
  extern __shared__ __align__(16) float smem[];
  float* pair_p = smem + (ntiles > 1 ? 2 : 1) * NIN * slab;
  float* pair_h = pair_p + NC * TW;
  float* carry = pair_h + NC * TW;

  const int wtiles = (s.W + TW - 1) / TW;
  const int b = blockIdx.x / wtiles, w0 = (blockIdx.x % wtiles) * TW;
  const int lw = threadIdx.x % TW, c = threadIdx.x / TW;
  const int w = w0 + lw;
  const bool live = w < s.W;
  const long long base = static_cast<long long>(b) * s.S * s.W;
  // Every element a thread touches in the slab-wide loops is in its lane
  // (THREADS is a multiple of TW), so the lane's coefficient is its own.
  const float coef = GATES ? -GRIFFIN_C * softplus_(live ? p.lam[w] : 0.f)
                           : 0.f;
  if (threadIdx.x < TW) carry[threadIdx.x] = 0.f;

  auto issue = [&](int k) {
    float* dst = smem + (k & 1) * NIN * slab;
    stage<TW>(dst, p.u0, base, k * TS, TS, w0, s);
    stage<TW>(dst + slab, p.u1, base, k * TS, TS, w0, s);
    if (GATES) stage<TW>(dst + 2 * slab, p.x, base, k * TS, TS, w0, s);
    cp_async_commit();
  };
  issue(0);
  for (int k = 0; k < ntiles; ++k) {
    if (k + 1 < ntiles) {
      issue(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* A = smem + (k & 1) * NIN * slab;
    float* BX = A + slab;
    if (GATES) {
      const float* X = A + 2 * slab;
      for (int e = threadIdx.x; e < slab; e += THREADS) {
        const float r = sigmoid_(A[e]);
        const float i = sigmoid_(BX[e]);
        const float log_a = coef * r;
        A[e] = expf(log_a);
        BX[e] = sqrtf(fmaxf(1.f - expf(2.f * log_a), SQRT_FLOOR))
                * (i * X[e]);
      }
      __syncthreads();
    }
    // Chunk c's own scan from zero: (prod a, local end).
    const int r0 = c * L;
    float h = 0.f, P = 1.f;
    for (int j = 0; j < L; ++j) {
      const int e = (r0 + j) * TW + lw;
      h = fmaf(A[e], h, BX[e]);
      P *= A[e];
    }
    pair_p[c * TW + lw] = P;
    pair_h[c * TW + lw] = h;
    __syncthreads();
    // Fold the chunks before c onto the tile's carry, then rescan.
    h = carry[lw];
    for (int cc = 0; cc < c; ++cc)
      h = fmaf(pair_p[cc * TW + lw], h, pair_h[cc * TW + lw]);
    const int t0 = k * TS + r0;
    float* yo = p.y + base + static_cast<long long>(t0) * s.W + w;
    for (int j = 0; j < L; ++j) {
      const int e = (r0 + j) * TW + lw;
      h = fmaf(A[e], h, BX[e]);
      if (live && t0 + j < s.S) yo[static_cast<long long>(j) * s.W] = h;
    }
    __syncthreads();                  // the tile's reads are done
    if (c == NC - 1) carry[lw] = h;
  }
}

template <bool GATES, int TW>
__global__ void __launch_bounds__(TW * NC) rglru_bwd_kernel(const BwdArgs p) {
  constexpr int NIN = bwd_inputs<GATES>();
  constexpr int THREADS = TW * NC;
  const Shape& s = p.s;
  const int L = s.L, TS = NC * L, slab = TS * TW;
  const int ntiles = tiles(s);
  const int stage_floats = bwd_stage_floats<GATES, TW>(s);
  extern __shared__ __align__(16) float smem[];
  // a of the tile's rows, then of the row after the tile (0 after S).
  float* A = smem + (ntiles > 1 ? 2 : 1) * stage_floats;
  float* pair_p = A + slab + TW;
  float* pair_h = pair_p + NC * TW;
  float* red = pair_h + NC * TW;
  float* gcarry = red + NC * TW;
  __shared__ int last_block;

  const int wtiles = (s.W + TW - 1) / TW;
  const int b = blockIdx.x / wtiles, w0 = (blockIdx.x % wtiles) * TW;
  const int lw = threadIdx.x % TW, c = threadIdx.x / TW;
  const int w = w0 + lw;
  const bool live = w < s.W;
  const long long base = static_cast<long long>(b) * s.S * s.W;
  const float coef = GATES ? -GRIFFIN_C * softplus_(live ? p.lam[w] : 0.f)
                           : 0.f;
  if (threadIdx.x < TW) {
    gcarry[threadIdx.x] = 0.f;
    A[slab + threadIdx.x] = 0.f;
  }
  float dcoef = 0.f;                  // this thread's share of d(coef)

  // Staged per tile: u0, [pre_i, x,] gy, then y from row t0 - 1.
  auto issue = [&](int k, int st) {
    float* dst = smem + st * stage_floats;
    const int t0 = k * TS;
    stage<TW>(dst, p.u0, base, t0, TS, w0, s);
    if (GATES) {
      stage<TW>(dst + slab, p.pre_i, base, t0, TS, w0, s);
      stage<TW>(dst + 2 * slab, p.x, base, t0, TS, w0, s);
    }
    stage<TW>(dst + (NIN - 1) * slab, p.gy, base, t0, TS, w0, s);
    stage<TW>(dst + NIN * slab, p.y, base, t0 - 1, TS + 1, w0, s);
    cp_async_commit();
  };
  issue(ntiles - 1, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int k = ntiles - 1 - it;
    if (it + 1 < ntiles) {
      issue(k - 1, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* U0 = smem + (it & 1) * stage_floats;
    float* GY = U0 + (NIN - 1) * slab;
    const float* Y = U0 + NIN * slab;  // Y[e] = y_{t-1} of element e
    for (int e = threadIdx.x; e < slab; e += THREADS)
      A[e] = GATES ? expf(coef * sigmoid_(U0[e])) : U0[e];
    __syncthreads();
    // Chunk c's own reverse scan from zero: (prod a_{t+1}, local start).
    const int r0 = c * L;
    float g = 0.f, P = 1.f;
    for (int j = L - 1; j >= 0; --j) {
      const int e = (r0 + j) * TW + lw;
      const float an = A[e + TW];
      g = fmaf(an, g, GY[e]);
      P *= an;
    }
    pair_p[c * TW + lw] = P;
    pair_h[c * TW + lw] = g;
    __syncthreads();
    // Fold the chunks after c onto the carry from the later tile, then
    // rescan, leaving g in place of gy.
    g = gcarry[lw];
    for (int cc = NC - 1; cc > c; --cc)
      g = fmaf(pair_p[cc * TW + lw], g, pair_h[cc * TW + lw]);
    for (int j = L - 1; j >= 0; --j) {
      const int e = (r0 + j) * TW + lw;
      g = fmaf(A[e + TW], g, GY[e]);
      GY[e] = g;
    }
    __syncthreads();
    if (c == 0) {                     // carries into the earlier tile
      gcarry[lw] = g;
      A[slab + lw] = A[lw];
    }
    const int t0 = k * TS;
    for (int e = threadIdx.x; e < slab; e += THREADS) {
      const int t = t0 + e / TW;
      const bool ok = live && t < s.S;
      const float gv = GY[e];
      const long long o = base + static_cast<long long>(t) * s.W + w;
      if (!GATES) {
        if (ok) {
          p.d0[o] = gv * Y[e];
          p.d1[o] = gv;
        }
        continue;
      }
      // Autograd's order through the plain version (ref.py::rglru_gates).
      const float rr = sigmoid_(U0[e]);
      const float a = A[e];
      const float log_a = coef * rr;
      const float e2 = expf(2.f * log_a);
      const float m = 1.f - e2;
      const float sq = sqrtf(fmaxf(m, SQRT_FLOOR));
      const float ii = sigmoid_(U0[slab + e]);
      const float xv = U0[2 * slab + e];
      const float ix = ii * xv;
      const float d_sq = gv * ix;
      const float d_ix = gv * sq;
      const float d_m = m >= SQRT_FLOOR ? d_sq / (2.f * sq) : 0.f;
      const float d_log_a = (gv * Y[e]) * a + (-d_m * e2) * 2.f;
      if (ok) {
        dcoef += d_log_a * rr;
        p.d0[o] = ((d_log_a * coef) * (1.f - rr)) * rr;
        p.d1[o] = ((d_ix * xv) * (1.f - ii)) * ii;
        p.dx[o] = d_ix * ii;
      }
    }
    __syncthreads();                  // the tile's reads are done
  }
  if (!GATES) return;
  // d_lam: this block's partial over its rows, then the last block's sum
  // over the blocks in batch order.
  red[c * TW + lw] = dcoef;
  __syncthreads();
  if (c == 0 && live) {
    float sum = 0.f;
    for (int cc = 0; cc < NC; ++cc) sum += red[cc * TW + lw];
    p.partial[static_cast<long long>(b) * s.W + w] = sum;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    last_block = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int wi = threadIdx.x; wi < s.W; wi += THREADS) {
    float sum = 0.f;
    for (int bb = 0; bb < s.B; ++bb)
      sum += __ldcg(p.partial + static_cast<long long>(bb) * s.W + wi);
    // d softplus = d coef * -8; logaddexp's: grad / (1 + exp(0 - lam)).
    p.dlam[wi] = (sum * -GRIFFIN_C) / (1.f + expf(-p.lam[wi]));
  }
  if (threadIdx.x == 0) *p.ticket = 0u;
}

bool aligned(const void* ptr) {
  return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0;
}

int check_shape(const Shape& s) {
  if (s.B < 1 || s.S < 1 || s.W < 1 || s.L < 1 || s.L > MAX_L)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(s.B) * ((s.W + 15) / 16);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// The largest shared memory a launch of a <GATES, TW> instantiation can
// ask for: chunks of MAX_L steps, two tiles (so two stages).
template <bool GATES, int TW>
inline int max_smem_bytes(bool forward) {
  const Shape s{1, 2 * NC * MAX_L, TW, MAX_L, 0};
  return static_cast<int>(sizeof(float))
         * (forward ? fwd_smem_floats<GATES, TW>(s)
                    : bwd_smem_floats<GATES, TW>(s));
}

// Launch `kernel`; above 48 KB its dynamic shared-memory limit is raised to
// `max_bytes` (what any launch of it can ask for) once per device, marked
// in `limit_set`, one set of flags a kernel.
template <typename Kernel, typename Args>
int launch(Kernel kernel, int blocks, int threads, int smem_floats,
           int max_bytes, std::atomic<unsigned long long>& limit_set,
           cudaStream_t stream, const Args& args) {
  const int bytes = smem_floats * static_cast<int>(sizeof(float));
  if (bytes > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned long long bit = 1ull << (dev & 63);
    if (!(limit_set.load() & bit)) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      limit_set.fetch_or(bit);
    }
  }
  kernel<<<blocks, threads, bytes, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <bool GATES>
int fwd(const FwdArgs& a, cudaStream_t stream) {
  static std::atomic<unsigned long long> set16{0}, set32{0};
  if (const int err = check_shape(a.s)) return err;
  if (a.s.W <= 16) {
    return launch(rglru_fwd_kernel<GATES, 16>, a.s.B * ((a.s.W + 15) / 16),
                  16 * NC, fwd_smem_floats<GATES, 16>(a.s),
                  max_smem_bytes<GATES, 16>(true), set16, stream, a);
  }
  return launch(rglru_fwd_kernel<GATES, 32>, a.s.B * ((a.s.W + 31) / 32),
                32 * NC, fwd_smem_floats<GATES, 32>(a.s),
                max_smem_bytes<GATES, 32>(true), set32, stream, a);
}

template <bool GATES>
int bwd(const BwdArgs& a, cudaStream_t stream) {
  static std::atomic<unsigned long long> set16{0}, set32{0};
  if (const int err = check_shape(a.s)) return err;
  if (a.s.W <= 16) {
    return launch(rglru_bwd_kernel<GATES, 16>, a.s.B * ((a.s.W + 15) / 16),
                  16 * NC, bwd_smem_floats<GATES, 16>(a.s),
                  max_smem_bytes<GATES, 16>(false), set16, stream, a);
  }
  return launch(rglru_bwd_kernel<GATES, 32>, a.s.B * ((a.s.W + 31) / 32),
                32 * NC, bwd_smem_floats<GATES, 32>(a.s),
                max_smem_bytes<GATES, 32>(false), set32, stream, a);
}

Shape shape(int B, int S, int W, int L, bool vec) {
  return Shape{B, S, W, L, vec && W % 4 == 0 ? 1 : 0};
}

}  // namespace

extern "C" {

// The fused forward: y [B, S, W] from pre_r, pre_i, x [B, S, W] and lam
// [W]; chunks of L steps (1..16), eight a tile. All float32, contiguous,
// on the current device. Launches on `stream`; returns a CUDA error code
// (0 on success).
int rglru_layer_fwd(const float* pre_r, const float* pre_i, const float* x,
                    const float* lam, float* y, int B, int S, int W, int L,
                    cudaStream_t stream) {
  const FwdArgs a{pre_r, pre_i, x, lam, y,
                  shape(B, S, W, L, aligned(pre_r) && aligned(pre_i)
                                    && aligned(x))};
  return fwd<true>(a, stream);
}

// The fused backward: d_pre_r, d_pre_i, d_x [B, S, W] and d_lam [W] from
// the forward's inputs, its y and the cotangent gy. `partial` is [B, W]
// scratch; `ticket` one unsigned int that is 0 and is left 0 (launches
// that share it must be ordered, as on one stream).
int rglru_layer_bwd(const float* pre_r, const float* pre_i, const float* x,
                    const float* lam, const float* y, const float* gy,
                    float* d_pre_r, float* d_pre_i, float* d_x, float* d_lam,
                    float* partial, unsigned* ticket, int B, int S, int W,
                    int L, cudaStream_t stream) {
  const BwdArgs a{pre_r, pre_i, x, lam, y, gy, d_pre_r, d_pre_i, d_x, d_lam,
                  partial, ticket,
                  shape(B, S, W, L, aligned(pre_r) && aligned(pre_i)
                                    && aligned(x) && aligned(y)
                                    && aligned(gy))};
  return bwd<true>(a, stream);
}

// The scan alone: y [B, S, W] from a and bx.
int rglru_scan_chunked_fwd(const float* a, const float* bx, float* y, int B,
                           int S, int W, int L, cudaStream_t stream) {
  const FwdArgs args{a, bx, nullptr, nullptr, y,
                     shape(B, S, W, L, aligned(a) && aligned(bx))};
  return fwd<false>(args, stream);
}

// The scan's backward: da, dbx [B, S, W] from a, the forward's y and gy.
int rglru_scan_chunked_bwd(const float* a, const float* y, const float* gy,
                           float* da, float* dbx, int B, int S, int W, int L,
                           cudaStream_t stream) {
  const BwdArgs args{a, nullptr, nullptr, nullptr, y, gy, da, dbx, nullptr,
                     nullptr, nullptr, nullptr,
                     shape(B, S, W, L, aligned(a) && aligned(y)
                                       && aligned(gy))};
  return bwd<false>(args, stream);
}

}  // extern "C"
