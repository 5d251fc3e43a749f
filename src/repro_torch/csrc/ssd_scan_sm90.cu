// Mamba-2 SSD scan (state-space duality, forward) on Hopper's tensor
// cores: the chunk-parallel form of arXiv:2405.21060 §6 in three launches,
// every product on wgmma, every x, B, C and state tile staged by TMA
// (sm_90a).
//
// Replaces: repro/kernels/ssd_scan/ssd_scan.py::ssd_scan_pallas (the
// Pallas TPU kernel, `_kernel`) for bf16 x, B and C with head dim P = 64,
// state size N in {64, 128} and chunk length L in {64, 128, 192, 256};
// float32 and every other shape keep the scalar kernel of ssd_scan.cu.
// With a = dt * A and acs its inclusive cumulative sum within a chunk:
//
//   y_l   = sum_{s <= l} (C_l . B_s) exp(acs_l - acs_s) dt_s x_s     (intra)
//         + exp(acs_l) C_l . h_in                                     (inter)
//   h_in <- exp(acs_{L-1}) h_in + sum_s exp(acs_{L-1} - acs_s) dt_s x_s B_s^T
//
// with B and C read at group g = h / (H / G), and h_in entering the first
// chunk h0 [b, H, P, N] (float32), or zero. Returns y [b, S, H, P] and the
// final state [b, H, P, N] in bf16, and the final state in float32 where the
// caller asks for it (the value a context-parallel segment hands on). With
// no y asked for, launches 1 and 2 run alone and write only the float32
// final state: the final state from zero of a segment
// (ssd_scan.py::ssd_final_cuda).
//
// Design. The TPU grid walked the chunks of one (b, h) stream in order with
// the state in VMEM; the scalar kernel does the same with one block per
// stream (b H blocks: 80 at B 1 on 132 SMs). Here the chunks are
// independent but for the [P, N] state they hand on, so the work splits in
// three launches, the first and last parallel over (b, chunk, head)
// (2560 CTAs at mamba2-2.7B's prefill, 640 at B 1):
//
//   1. ssd_chunk_state, one CTA of one warpgroup per (b, c, h): the chunk's
//      own contribution S_c = (x * w)^T B with w_s = exp(acs_{L-1} - acs_s)
//      dt_s, [P, N] in float32, as wgmma.m64nNk16 over K = L (x^T is the
//      MN-major A operand, B the MN-major B operand), and the chunk's decay
//      exp(acs_{L-1}). The row tiles pass through a ring of two stages
//      (64 KB at N 128), so three CTAs share an SM and one's loads overlap
//      another's products.
//   2. ssd_state_pass, one thread per 4 elements of (b, h, P, N): walks the
//      chunks in order, h_in[0] = h0 (or 0), h_in[c+1] = decay_c h_in[c] +
//      S_c, in float32; writes h_in[c] as a bf16 hi + lo pair (the operand
//      of launch 3; for c = 0 only where h0 is given) and the final state.
//   3. ssd_chunk_scan, one CTA per (b, c, h) holding its whole chunk (C, B,
//      x and h_in: 192 KB at L 256, N 128), one mbarrier per row tile so
//      that the first tile's products start while the later tiles are in
//      flight; two consumer warpgroups of 64 chunk rows at a time (the row
//      tiles are dealt so that both get the same number of causal tile
//      pairs: {0, 3} and {1, 2} at L 256). Per row tile: y = exp(acs_l)
//      (C h_in^T) on wgmma (C and h_in from shared memory, K-major), then
//      for each column tile s <= l's tile: S = C B^T on wgmma into float32
//      registers, P = S exp(acs_l - acs_s) dt_s formed in registers (only
//      tiles with s <= l are visited), and y += P x on wgmma with P from
//      registers and x the MN-major B operand. The decay is split into a
//      row and a column factor where that is exact (see ssd_chunk_scan):
//      formed per element, the exps took about half the launch's cycles
//      (measured on the card). y goes
//      through shared memory (C's tile of the row tile, in the swizzle) and
//      out by one TMA store.
//
// Tiles are [64 rows][64 bf16 columns], 128 bytes a row with the 128-byte
// swizzle (TMA writes them, the wgmma descriptors read them: SBO = 1024
// bytes between 8-row groups; a K-major k step advances 32 bytes inside a
// row, an MN-major one 16 rows). x, B, C and y move through 4-D tensor maps
// over [b, S, heads or groups, 64 columns], so a tile never crosses into the
// next sequence: rows past S are zero-filled by TMA and read as dt = 0,
// which is the exact padding of models/ssm.py::ssd_chunked, and are not
// stored. Row tiles that lie wholly past S are neither loaded nor computed.
//
// Numbers. The products of bf16 values are exact and summed in float32.
// Three operands are float32 values that are not bf16: launch 1's x * w,
// launch 3's h_in and launch 3's P. Each is fed as a bf16 hi + lo pair (hi
// the top 16 bits, lo the rest rounded), two wgmmas on the same other
// operand, which carries 16 of float32's 24 bits; plain bf16 P breaks the
// 2e-3 limit (the plain twin with this rounding,
// kernels/ssd_scan/ref.py::ssd_chunk_parallel(rounding="kernel"), is held to
// the limit on the CPU). exp(acs_l - acs_s) is only formed for s <= l (for
// s > l it overflows); expf, and no --use_fast_math.
//
// Bound. At mamba2-2.7B prefill (b 4, S 2048, H 80, P 64, G 1, N 128, L 256)
// the function's causal products are 53.7 GFLOP, 54 us at the bf16
// tensor-core peak (989 TFLOP/s, H100 SXM data sheet, 700 W); its bytes
// (x, dt, B, C read once, y and the state written once) are 180 MB, 54 us at
// 3.35 TB/s. This design does more: S_c and h_in cross device memory
// (84 MB each way in float32 / bf16 pairs), x is read twice, C B^T is
// formed per head, not per group, and the hi + lo pairs double two of the
// three products: ~0.6 GB and ~100 GFLOP of tensor work. Launch 3 keeps one
// CTA on an SM, which waits for its chunk's data with the tensor cores idle
// (the chunk is the unit of work; PERF.md has the measured phases).
//
// The tensor maps are encoded on the host with the driver's
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, as in
// flash_attention_sm90.cu.

#include <cuda.h>            // CUtensorMap and its enums; no driver calls
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int HD = 64;                  // head dim P
constexpr int TR = 64;                  // rows of a tile
constexpr int ROW_BYTES = 128;          // 64 bf16 columns
constexpr int TILE = TR * ROW_BYTES;    // 8 KB
constexpr int MAX_L = 256;
constexpr int MAX_TILES = MAX_L / TR;
constexpr int STATE_THREADS = 128;      // launch 1
constexpr int SCAN_THREADS = 256;       // launch 3: two consumer warpgroups
constexpr int PASS_THREADS = 256;       // launch 2
// The largest acs span of a diagonal tile whose decay is factored: each
// factor stays within exp(+-64), clear of float32's range.
constexpr float FACTOR_SPAN = 64.f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}
// K-major operand (K contiguous): k step kk of a [64][64 * chunks] tile
// whose 64-column chunks lie `chunk_bytes` apart.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk,
                                           uint32_t chunk_bytes) {
  return sw128_desc(tile + (kk / 4) * chunk_bytes + (kk % 4) * 32, 16, 1024);
}
// MN-major operand (M or N contiguous): k step kk (16 rows) of a tile whose
// 64-column chunks lie `chunk_bytes` apart.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk,
                                            uint32_t chunk_bytes) {
  return sw128_desc(tile + kk * 16 * ROW_BYTES, chunk_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a0, a1) as bf16x2 hi + lo: hi keeps each float's top 16 bits (its bf16
// truncation, one byte permute for the pair), lo = a - hi (exact in
// float32) rounded to bf16; hi + lo carries 16 of float32's 24 significant
// bits.
__device__ __forceinline__ void split_bf16(float a0, float a1, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t u0 = __float_as_uint(a0), u1 = __float_as_uint(a1);
  hi = __byte_perm(u0, u1, 0x7632);
  lo = pack_bf16(a0 - __uint_as_float(u0 & 0xffff0000u),
                 a1 - __uint_as_float(u1 & 0xffff0000u));
}

#define D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define REGS32                                                             \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define REGS64                                                             \
  REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63"

// d[0:32] (+)= A[64 x 16] . B[16 x 64], both from shared memory; TA / TB:
// A / B MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" REGS32
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" REGS64
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[0:32] += A[64 x 16] (registers) . B[16 x 64], B MN-major in shared
// memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" REGS32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef D8
#undef REGS32
#undef REGS64

// Stage 1's product, N = 64 or 128 columns of state.
template <int NC>
struct StateAcc;
template <>
struct StateAcc<1> {
  float d[32];
  __device__ __forceinline__ void mma(uint64_t da, uint64_t db, int acc) {
    wgmma_ss_n64<1, 1>(d, da, db, acc);
  }
};
template <>
struct StateAcc<2> {
  float d[64];
  __device__ __forceinline__ void mma(uint64_t da, uint64_t db, int acc) {
    wgmma_ss_n128<1, 1>(d, da, db, acc);
  }
};

// dt of this thread's rows of the chunk, 0 past the `valid` rows: NT
// threads, each owning MAX_L / NT consecutive rows. Loaded first, so that
// the loads are in flight while thread 0 issues the TMA copies.
template <int NT>
__device__ __forceinline__ void load_dt(const float* __restrict__ dtb, int H,
                                        int valid, float (&d)[MAX_L / NT]) {
#pragma unroll
  for (int r = 0; r < MAX_L / NT; ++r) {
    const int l = threadIdx.x * (MAX_L / NT) + r;
    d[r] = l < valid ? dtb[static_cast<size_t>(l) * H] : 0.f;
  }
}

// dt of the chunk's L rows and the inclusive cumulative sum of a = dt * A,
// into shared memory, from load_dt's values: a warp scan of the threads'
// totals and a scan of the warps' totals. Ends with __syncthreads().
template <int NT>
__device__ __forceinline__ void chunk_cumsum(const float (&d)[MAX_L / NT],
                                             int L, float Ah, float* dtv,
                                             float* acs, float* wsum) {
  constexpr int R = MAX_L / NT;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float v[R];
  float run = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int l = tid * R + r;
    if (l < L) dtv[l] = d[r];
    run += d[r] * Ah;
    v[r] = run;
  }
  float t = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, t, off);
    if (lane >= off) t += n;
  }
  if (lane == 31) wsum[warp] = t;
  __syncthreads();
  if (warp == 0) {
    float s = lane < NT / 32 ? wsum[lane] : 0.f;
#pragma unroll
    for (int off = 1; off < NT / 32; off <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += n;
    }
    if (lane < NT / 32) wsum[lane] = s;
  }
  __syncthreads();
  const float base = (warp > 0 ? wsum[warp - 1] : 0.f) + t - run;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int l = tid * R + r;
    if (l < L) acs[l] = base + v[r];
  }
  __syncthreads();
}

// ---- launch 1: the chunk's own state contribution -------------------------
//
// The chunk's row tiles pass through a ring of RING stages in dynamic shared
// memory (from a 1024-aligned base), each holding X (a tile of x; hi of
// x * w after scaling, in place), XL (lo) and NC tiles of B, then RING
// mbarriers: 64 KB at N 128, so three CTAs share an SM.
constexpr int RING = 2;

template <int NC>
__global__ void __launch_bounds__(STATE_THREADS, 3)
ssd_chunk_state(const __grid_constant__ CUtensorMap x_map,
                const __grid_constant__ CUtensorMap b_map,
                const float* __restrict__ dt, const float* __restrict__ A,
                float* __restrict__ sc, float* __restrict__ decay, int S,
                int H, int G, int L) {
  constexpr int N = 64 * NC;
  constexpr uint32_t STAGE = (2 + NC) * TILE;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bar0 = base + RING * STAGE;
  __shared__ float dtv[MAX_L], acs[MAX_L], w[MAX_L];
  __shared__ float wsum[STATE_THREADS / 32];

  const int nc = (S + L - 1) / L;
  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int c = bc % nc, bb = bc / nc, g = h / (H / G);
  const int cs = c * L, valid = min(L, S - cs);
  const int nvt = (valid + TR - 1) / TR;    // row tiles holding real rows
  // Row tile t into stage t % RING.
  auto load = [&](int t) {
    const uint32_t st = base + (t % RING) * STAGE, bar = bar0 + 8 * (t % RING);
    mbar_expect_tx(bar, (1 + NC) * TILE);
    tma_load_4d(st, &x_map, bar, 0, h, cs + t * TR, bb);
    for (int k = 0; k < NC; ++k)
      tma_load_4d(st + (2 + k) * TILE, &b_map, bar, k * 64, g, cs + t * TR,
                  bb);
  };

  float d[MAX_L / STATE_THREADS];
  load_dt<STATE_THREADS>(dt + (static_cast<size_t>(bb) * S + cs) * H + h, H,
                         valid, d);
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < min(nvt, RING); ++t) load(t);
  }
  chunk_cumsum<STATE_THREADS>(d, L, A[h], dtv, acs, wsum);
  const float last = acs[L - 1];
  for (int l = threadIdx.x; l < L; l += STATE_THREADS)
    w[l] = expf(last - acs[l]) * dtv[l];
  if (threadIdx.x == 0) decay[blockIdx.x] = expf(last);
  __syncthreads();

  StateAcc<NC> acc;
  for (int t = 0; t < nvt; ++t) {
    const uint32_t st = base + (t % RING) * STAGE;
    mbar_wait(bar0 + 8 * (t % RING), (t / RING) & 1);
    // x * w_s as hi (in place) + lo. The swizzle permutes 16-byte chunks
    // within a 128-byte row, so a chunk's row is its offset / 128.
    for (int q = threadIdx.x; q < TILE / 16; q += STATE_THREADS) {
      const float ws = w[t * TR + q / 8];
      uint4* hp = reinterpret_cast<uint4*>(gbase + (st - base) + q * 16);
      uint4* lp = reinterpret_cast<uint4*>(gbase + (st - base) + TILE +
                                           q * 16);
      uint4 v = *hp, lo;
      uint32_t* vh = reinterpret_cast<uint32_t*>(&v);
      uint32_t* vl = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<__nv_bfloat162*>(&vh[k]));
        split_bf16(f.x * ws, f.y * ws, vh[k], vl[k]);
      }
      *hp = v;
      *lp = lo;
    }
    // The generic-proxy stores must be visible to wgmma's async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TR / 16; ++kk) {
      const uint64_t db = mnmajor(st + 2 * TILE, kk, TILE);
      acc.mma(mnmajor(st, kk, TILE), db, t > 0 || kk > 0);
      acc.mma(mnmajor(st + TILE, kk, TILE), db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    // Every thread's products are done with the stage: refill it.
    __syncthreads();
    if (threadIdx.x == 0 && t + RING < nvt) load(t + RING);
  }
  fence_regs(acc.d);

  // S_c [P, N] float32: element 4 j + e is row p = 16 warp + lane / 4 +
  // 8 (e / 2), column n = 8 j + 2 (lane % 4) + e % 2.
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* out = sc + static_cast<size_t>(blockIdx.x) * HD * N;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = 16 * warp + lane / 4 + 8 * r, n = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<float2*>(out + p * N + n) =
          make_float2(acc.d[4 * j + 2 * r], acc.d[4 * j + 2 * r + 1]);
    }
}

// ---- launch 2: the state pass -------------------------------------------
//
// One thread per 4 consecutive elements of a (b, h) stream's [P, N] state,
// walking the chunks in order in float32 from h0 (or zero). h_in[c] goes
// out as a bf16 hi + lo pair, hin[(b, c, h)][2][P][N], for c >= 1 and, where
// h0 is given, c = 0 (no hin: the final state alone); the final state in
// bf16 (st) and in float32 (st32), each where asked for.
__global__ void __launch_bounds__(PASS_THREADS)
ssd_state_pass(const float* __restrict__ sc, const float* __restrict__ decay,
               const float* __restrict__ h0,
               __nv_bfloat16* __restrict__ hin,
               __nv_bfloat16* __restrict__ st, float* __restrict__ st32,
               int b, int nc, int H, int PN) {
  const int q = blockIdx.x * PASS_THREADS + threadIdx.x;
  const int per = PN / 4;
  if (q >= b * H * per) return;
  const int e = (q % per) * 4, bh = q / per, h = bh % H, bb = bh / H;
  const size_t at = static_cast<size_t>(bh) * PN + e;
  float4 v = h0 != nullptr ? *reinterpret_cast<const float4*>(h0 + at)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc; ++c) {
    const size_t item = (static_cast<size_t>(bb) * nc + c) * H + h;
    if (hin != nullptr && (c > 0 || h0 != nullptr)) {
      __nv_bfloat16* hp = hin + item * 2 * PN + e;
      uint2 hi, lo;
      split_bf16(v.x, v.y, hi.x, lo.x);
      split_bf16(v.z, v.w, hi.y, lo.y);
      *reinterpret_cast<uint2*>(hp) = hi;
      *reinterpret_cast<uint2*>(hp + PN) = lo;
    }
    const float d = decay[item];
    const float4 s = *reinterpret_cast<const float4*>(sc + item * PN + e);
    v = make_float4(fmaf(d, v.x, s.x), fmaf(d, v.y, s.y), fmaf(d, v.z, s.z),
                    fmaf(d, v.w, s.w));
  }
  if (st != nullptr) {
    uint2 out;
    const __nv_bfloat162 o01 = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 o23 = __floats2bfloat162_rn(v.z, v.w);
    out.x = *reinterpret_cast<const uint32_t*>(&o01);
    out.y = *reinterpret_cast<const uint32_t*>(&o23);
    *reinterpret_cast<uint2*>(st + at) = out;
  }
  if (st32 != nullptr) *reinterpret_cast<float4*>(st32 + at) = v;
}

// ---- launch 3: the chunk's output -----------------------------------------

// The 64 x 64 weights of one tile pair, P = S exp(acs_l - acs_s) dt_s for
// s <= l, as bf16 hi and lo wgmma A fragments (the accumulator's layout of
// a 16-column slice is the A fragment's: slice kk holds n8 blocks 2 kk and
// 2 kk + 1). Factored, P = S E[l] F[s] with exp(acs_l - acs_s) dt_s =
// E[l] F[s] (see ssd_chunk_scan); else the exact form, an expf per element.
__device__ __forceinline__ void weights(const float (&sc)[32], int row_lo,
                                        int col0, bool factored, bool diag,
                                        const float* E, const float* F,
                                        const float* acs, const float* dtv,
                                        uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
  float p[32];
  if (factored) {
    const float e[2] = {E[row_lo], E[row_lo + 8]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int l = row_lo + 8 * (q >> 1), s = col0 + 8 * j + (q & 1);
        p[4 * j + q] = diag && s > l ? 0.f : sc[4 * j + q] * e[q >> 1] * F[s];
      }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int l = row_lo + 8 * (q >> 1), s = col0 + 8 * j + (q & 1);
        // Select before the exp: for s > l the exponent is positive.
        p[4 * j + q] =
            s <= l ? sc[4 * j + q] * expf(acs[l] - acs[s]) * dtv[s] : 0.f;
      }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // register r: n8 block 2 kk + r / 2, row half r % 2
      const int i = 4 * (2 * kk + r / 2) + 2 * (r % 2);
      split_bf16(p[i], p[i + 1], hi[kk][r], lo[kk][r]);
    }
}

// Dynamic shared memory (from a 1024-aligned base): Ct [nt][NC], Bt
// [nt][NC] and Xt [nt] tiles, Ht [2][NC] tiles of h_in (hi, lo; [P rows]
// [N]), then nt + 1 mbarriers. `has_h0`: the state entering chunk 0 is
// launch 2's h_in[0] (from h0), not zero.
template <int NC>
__global__ void __launch_bounds__(SCAN_THREADS, 1)
ssd_chunk_scan(const __grid_constant__ CUtensorMap x_map,
               const __grid_constant__ CUtensorMap b_map,
               const __grid_constant__ CUtensorMap c_map,
               const __grid_constant__ CUtensorMap h_map,
               const __grid_constant__ CUtensorMap y_map,
               const float* __restrict__ dt, const float* __restrict__ A,
               int S, int H, int G, int L, int has_h0) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int nt = L / TR, nc = (S + L - 1) / L;
  const uint32_t c_s = base, b_s = c_s + nt * NC * TILE;
  const uint32_t x_s = b_s + nt * NC * TILE, h_s = x_s + nt * TILE;
  const uint32_t bar0 = h_s + 2 * NC * TILE;
  const uint32_t hbar = bar0 + 8 * MAX_TILES;
  __shared__ float dtv[MAX_L], acs[MAX_L], wsum[SCAN_THREADS / 32];
  // Factors of exp(acs_l - acs_s) dt_s: Eo[st][l] Fo[s] for s in column
  // tile st < l's tile, Ed[l] Fd[s] for s and l in one tile.
  __shared__ float Eo[(MAX_TILES - 1) * MAX_L], Fo[MAX_L], Ed[MAX_L],
      Fd[MAX_L];

  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int c = bc % nc, bb = bc / nc, g = h / (H / G);
  const int cs = c * L, valid = min(L, S - cs);
  const int nvt = (valid + TR - 1) / TR;
  // A state enters the chunk: every chunk but the first, and the first
  // where h0 is given.
  const bool carried = c > 0 || has_h0;

  float d[MAX_L / SCAN_THREADS];
  load_dt<SCAN_THREADS>(dt + (static_cast<size_t>(bb) * S + cs) * H + h, H,
                        valid, d);
  // Thread 0 sets up the barriers with the bytes each awaits; then one lane
  // of warp t issues row tile t's copies and one of warp MAX_TILES the
  // state's, so that the copies leave together.
  if (threadIdx.x == 0) {
    for (int t = 0; t < nvt; ++t) {
      mbar_init(bar0 + 8 * t, 1);
      mbar_expect_tx(bar0 + 8 * t, (2 * NC + 1) * TILE);
    }
    mbar_init(hbar, 1);
    // Without h0 the state entering chunk 0 is zero: nothing to load.
    if (carried) mbar_expect_tx(hbar, 2 * NC * TILE);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp_id = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0 && warp_id < nvt) {
    const int t = warp_id;
    const uint32_t bar = bar0 + 8 * t;
    for (int k = 0; k < NC; ++k) {
      tma_load_4d(c_s + (t * NC + k) * TILE, &c_map, bar, k * 64, g,
                  cs + t * TR, bb);
      tma_load_4d(b_s + (t * NC + k) * TILE, &b_map, bar, k * 64, g,
                  cs + t * TR, bb);
    }
    tma_load_4d(x_s + t * TILE, &x_map, bar, 0, h, cs + t * TR, bb);
  }
  if (threadIdx.x == 32 * MAX_TILES && carried)
    for (int part = 0; part < 2; ++part)
      for (int k = 0; k < NC; ++k)
        tma_load_3d(h_s + (part * NC + k) * TILE, &h_map, hbar, k * 64, 0,
                    2 * blockIdx.x + part);
  chunk_cumsum<SCAN_THREADS>(d, L, A[h], dtv, acs, wsum);

  // Where a = dt A <= 0 on every row, acs does not increase, and
  // exp(acs_l - acs_s) = exp(acs_l - m) exp(m - acs_s) splits without
  // overflow: across tiles with m = acs at the end of the column tile (both
  // factors <= 1; one that underflows takes a product below it to 0), on
  // the diagonal with m = acs at the tile's row 31 where the tile spans less
  // than FACTOR_SPAN (every factor within exp(+-FACTOR_SPAN)). An expf per
  // row and factor replaces one per element; elsewhere the exact form.
  bool falls = true;
  {
    const int l = threadIdx.x, t = l / TR;
    if (l < L) {
      const float al = acs[l], mid = acs[t * TR + TR / 2 - 1];
      Fo[l] = expf(acs[t * TR + TR - 1] - al) * dtv[l];
      Fd[l] = expf(mid - al) * dtv[l];
      Ed[l] = expf(al - mid);
      for (int u = 0; u < t; ++u)
        Eo[u * MAX_L + l] = expf(al - acs[u * TR + TR - 1]);
      falls = dtv[l] * A[h] <= 0.f;
    }
  }
  const bool mono = __syncthreads_and(falls);

  // Deal the row tiles to the two warpgroups, heaviest first, each to the
  // one with fewer causal tile pairs so far.
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid % 32, warp = tid / 32;
  unsigned mine = 0;
  {
    int load[2] = {0, 0};
    for (int t = nvt - 1; t >= 0; --t) {
      const int to = load[0] <= load[1] ? 0 : 1;
      load[to] += t + 1;
      if (to == wg) mine |= 1u << t;
    }
  }
  for (int lt = nvt - 1; lt >= 0; --lt) {
    if (!(mine >> lt & 1u)) continue;
    const int row_lo = lt * TR + 16 * warp + lane / 4;   // and row_lo + 8
    const uint32_t c_tile = c_s + lt * NC * TILE;
    float acc[32];
    mbar_wait(bar0 + 8 * lt, 0);
    if (carried) {
      // y = exp(acs_l) (C h_in^T): h_in is the K-major B operand.
      mbar_wait(hbar, 0);
      wgmma_fence();
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int kk = 0; kk < NC * 4; ++kk)
          wgmma_ss_n64<0, 0>(acc, kmajor(c_tile, kk, TILE),
                             kmajor(h_s + part * NC * TILE, kk, TILE),
                             part > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      const float e0 = expf(acs[row_lo]), e1 = expf(acs[row_lo + 8]);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= (i & 2) ? e1 : e0;
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    }
    for (int st = 0; st <= lt; ++st) {
      mbar_wait(bar0 + 8 * st, 0);
      // S = C B^T: B's rows are the K-major B operand.
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NC * 4; ++kk)
        wgmma_ss_n64<0, 0>(sc, kmajor(c_tile, kk, TILE),
                           kmajor(b_s + st * NC * TILE, kk, TILE), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      uint32_t hi[4][4], lo[4][4];
      const bool diag = st == lt;
      weights(sc, row_lo, st * TR + 2 * (lane % 4),
              mono && (!diag || acs[lt * TR] - acs[lt * TR + TR - 1] <
                                    FACTOR_SPAN),
              diag, diag ? Ed : Eo + st * MAX_L, diag ? Fd : Fo, acs, dtv,
              hi, lo);
      fence_regs(acc);
      fence_regs(hi);
      fence_regs(lo);
      // y += P x: x is the MN-major B operand.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = mnmajor(x_s + st * TILE, kk, TILE);
        wgmma_rs_n64(acc, hi[kk], db);
        wgmma_rs_n64(acc, lo[kk], db);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(hi);
      fence_regs(lo);
    }
    // y in bf16 into C's tile of this row tile (no longer read), in the
    // 128-byte swizzle: element 4 j + e is row row_lo + 8 (e / 2), column
    // 8 j + 2 (lane % 4) + e % 2; then one TMA store of the tile (rows past
    // S are not written).
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + lane / 4 + 8 * r;
      const uint32_t at = c_tile + row * ROW_BYTES + 4 * (lane % 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                         at + ((j ^ (row % 8)) * 16)),
                     "r"(*reinterpret_cast<const uint32_t*>(&v))
                     : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (tid == 0) {
      asm volatile(
          "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
          " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
              reinterpret_cast<uint64_t>(&y_map)),
          "r"(c_tile), "r"(0), "r"(h), "r"(cs + lt * TR), "r"(bb)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  // The stores must have read shared memory before the CTA leaves it.
  if (tid == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---- host side -------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Error codes beyond CUDA's: the driver entry point is missing, or the
// driver refused a tensor map (ENCODE_FAILED + its CUresult).
constexpr int NO_ENCODER = 10000;
constexpr int ENCODE_FAILED = 20000;

// A contiguous bf16 tensor of `rank` dims (innermost first, dims[0] = 64
// columns a row) as a tensor map with boxes of 64 columns x `box_rows`
// along dims[rows_dim] (1 along the others), 128-byte swizzle, elements
// out of bounds read as 0.
int make_map(CUtensorMap* map, const void* ptr, int rank,
             const cuuint64_t* dims, int rows_dim, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return NO_ENCODER;
  cuuint64_t strides[4];
  cuuint64_t stride = 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = stride *= dims[i];
  cuuint32_t box[5] = {64, 1, 1, 1, 1};
  box[rows_dim] = static_cast<cuuint32_t>(box_rows);
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + static_cast<int>(r);
}

// Dynamic shared memory of the two chunk kernels: the tiles, the 1024-byte
// alignment of the base and the mbarriers.
int state_smem(int NC) { return 1024 + RING * (2 + NC) * TILE + 8 * RING; }
int scan_smem(int NC, int nt) {
  return 1024 + ((2 * NC + 1) * nt + 2 * NC) * TILE + 8 * (MAX_TILES + 1);
}

template <int NC>
int launch(const void* x, const float* dt, const float* A, const void* B,
           const void* C, const float* h0, void* y, void* st, float* st32,
           float* sc, float* decay, void* hin, int b, int S, int H, int G,
           int L, cudaStream_t stream) {
  constexpr int N = 64 * NC;
  const int nt = L / TR, nc = (S + L - 1) / L, items = b * nc * H;
  CUtensorMap x_map, b_map, c_map, h_map, y_map;
  const cuuint64_t xd[4] = {HD, static_cast<cuuint64_t>(H),
                            static_cast<cuuint64_t>(S),
                            static_cast<cuuint64_t>(b)};
  const cuuint64_t bd[4] = {N, static_cast<cuuint64_t>(G),
                            static_cast<cuuint64_t>(S),
                            static_cast<cuuint64_t>(b)};
  const cuuint64_t hd[3] = {N, HD, static_cast<cuuint64_t>(2) * items};
  int err = make_map(&x_map, x, 4, xd, 2, TR);
  if (err == 0) err = make_map(&b_map, B, 4, bd, 2, TR);
  // Launch 3's maps, where there is a y to form.
  if (err == 0 && y != nullptr) err = make_map(&c_map, C, 4, bd, 2, TR);
  if (err == 0 && y != nullptr) err = make_map(&h_map, hin, 3, hd, 1, HD);
  if (err == 0 && y != nullptr) err = make_map(&y_map, y, 4, xd, 2, TR);
  if (err != 0) return err;

  const int smem1 = state_smem(NC), smem3 = scan_smem(NC, nt);
  // The shared-memory limits, once per device: launch 3's for the longest
  // chunk, which covers every shorter one.
  static std::atomic<unsigned long long> limits_set{0};
  int dev = 0;
  cudaError_t cerr = cudaGetDevice(&dev);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(limits_set.load() & bit)) {
    cerr = cudaFuncSetAttribute(
        ssd_chunk_state<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem1);
    if (cerr == cudaSuccess)
      cerr = cudaFuncSetAttribute(
          ssd_chunk_scan<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          scan_smem(NC, MAX_TILES));
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
    limits_set.fetch_or(bit);
  }

  ssd_chunk_state<NC><<<items, STATE_THREADS, smem1, stream>>>(
      x_map, b_map, dt, A, sc, decay, S, H, G, L);
  if ((cerr = cudaGetLastError()) != cudaSuccess)
    return static_cast<int>(cerr);
  const int quads = b * H * HD * N / 4;
  ssd_state_pass<<<(quads + PASS_THREADS - 1) / PASS_THREADS, PASS_THREADS,
                   0, stream>>>(
      sc, decay, h0,
      y != nullptr ? static_cast<__nv_bfloat16*>(hin) : nullptr,
      static_cast<__nv_bfloat16*>(st), st32, b, nc, H, HD * N);
  if ((cerr = cudaGetLastError()) != cudaSuccess || y == nullptr)
    return static_cast<int>(cerr);
  ssd_chunk_scan<NC><<<items, SCAN_THREADS, smem3, stream>>>(
      x_map, b_map, c_map, h_map, y_map, dt, A, S, H, G, L, h0 != nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y [b, S, H, 64] and the final state [b, H, 64, N] from x [b, S, H, 64],
// dt [b, S, H] (float32), A [H] (float32), B, C [b, S, G, N] and the state
// entering the first chunk h0 [b, H, 64, N] (float32; null: zero); x, B, C,
// y and st bfloat16, st32 the final state in float32; N in {64, 128}; chunk
// length L a multiple of 64 up to 256; G divides H; all contiguous and
// 16-byte aligned on the current device. st and st32 may each be null (not
// written); with y null only launches 1 and 2 run (hin unused). Scratch
// from the caller, with nc = ceil(S / L): sc float32 [b, nc, H, 64, N],
// decay float32 [b, nc, H], hin bfloat16 [b, nc, H, 2, 64, N]. Launches the
// kernels on `stream`; returns 0 on success, a CUDA error code, or 10000
// (no cuTensorMapEncodeTiled) / 20000 + CUresult (a tensor map was
// refused).
int ssd_scan_fwd_sm90(const void* x, const float* dt, const float* A,
                      const void* B, const void* C, const float* h0, void* y,
                      void* st, float* st32, float* sc, float* decay,
                      void* hin, int b, int S, int H, int G, int N, int L,
                      cudaStream_t stream) {
  if (b < 1 || S < 1 || H < 1 || G < 1 || H % G != 0 || L < TR ||
      L > MAX_L || L % TR != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (N) {
    case 64: return launch<1>(x, dt, A, B, C, h0, y, st, st32, sc, decay,
                              hin, b, S, H, G, L, stream);
    case 128: return launch<2>(x, dt, A, B, C, h0, y, st, st32, sc, decay,
                               hin, b, S, H, G, L, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
