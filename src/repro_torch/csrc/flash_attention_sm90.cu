// Flash attention (forward) on Hopper's tensor cores, bf16 in and out,
// head dim 64 or 128: wgmma for both products, TMA for every tile, one
// producer warp and two consumer warpgroups per CTA (sm_90a).
//
// Replaces: repro/kernels/flash_attention/flash_attention.py::
// flash_attention_bh (the Pallas TPU kernel, `_kernel`), for bf16 inputs
// with D in {64, 128}; float32 inputs and D in {16, 256} keep the scalar
// kernel of flash_attention.cu. For each query head h and query row i, with
// kv head h / group:
//
//   o_i = sum_j softmax_j(scale * q_i . k_j + mask_ij) v_j
//
// where mask_ij is 0 where key j is visible to query i (j < Skv; causal:
// j <= i; sliding: also i - j < window) and NEG_INF = -2e38 elsewhere.
//
// Bound. At qwen2-1.5B prefill (B 4, S 2048, 12 q heads over 2 kv heads,
// D 128, causal) the two products are 51.5 GFLOP over the causal triangle:
// 52 us at the bf16 tensor-core peak (989 TFLOP/s, H100 SXM data sheet,
// 700 W); q, k, v read once and o written once are 59 MB, 18 us at
// 3.35 TB/s. Operations bound it, so the products must run on wgmma.
//
// Design.
//   * Persistent CTAs: one per SM (fewer if there are fewer items), each
//     walking work items (q head, q tile of BQ = 128 rows). Items are
//     ordered heaviest causal q tile first, the heads that share a kv head
//     side by side, and dealt to the CTAs in snake order (forwards, then
//     backwards, round by round), which balances the causal work about as
//     well as the hardware's dynamic scheduling of one CTA per item did.
//     Staying resident, a CTA loads the next item's Q and first K and V
//     tiles while it finishes the current one, where a fresh CTA would
//     wait for them.
//   * Three warpgroups. Warpgroup 2 is the producer: after `setmaxnreg` has
//     cut it to 24 registers, one thread issues TMA loads
//     (cp.async.bulk.tensor.3d, completion on an mbarrier) of each item's Q
//     (single-buffered: it waits for both consumers' `q_empty`) and of the
//     K and V tiles (BK = 128 keys) into a ring of STAGES = 3 stages that
//     runs on across items, waiting on each stage's `empty` barrier before
//     it reuses it. K and V have barriers of their own, so S = Q K^T starts
//     before V lands.
//     Warpgroups 0 and 1 are consumers (240 registers each), 64 query rows
//     apiece: wgmma's M.
//   * Tensor maps are 3-D (D, S, heads) views of the contiguous [BH, S, D]
//     tensors, so a tile never crosses into the next head: rows past Sq or
//     Skv are filled with zeros by TMA. Boxes are 64 columns (128 bytes)
//     wide with the 128-byte swizzle; a D = 128 row is two such boxes, kept
//     as two [rows][64] column chunks. The wgmma descriptors use the same
//     swizzle: Q and K are K-major (D contiguous; SBO = 1024 bytes between
//     8-row groups, a 16-column k step advances the start by 32 bytes
//     inside a chunk), V is MN-major for the second product (transposed B;
//     LBO = the chunk stride, SBO = 1024 bytes, a 16-key k step advances
//     by 16 rows).
//   * S = Q K^T: D / 16 wgmma.m64n128k16 (bf16 from shared memory, float32
//     accumulator, 64 floats a thread). The online softmax runs on that
//     accumulator in registers: a thread holds two rows, each spread over
//     the 4 threads of a quad, so a row max is two __shfl_xor_sync steps;
//     the row sum stays per thread until the end.
//   * O += P V: P is rounded to bf16 in registers and fed as wgmma's A
//     operand from registers (the accumulator's layout of a 16-key slice is
//     the A fragment's), 128 / 16 wgmma.m64n{D}k16 with V from shared
//     memory; O (D / 2 floats a thread) is rescaled in registers.
//   * Software pipeline within a warpgroup: each step issues tile t's
//     S = Q K^T and tile t - 1's O += P V back to back, waits for the
//     first only, and runs tile t's softmax on the CUDA cores (exp2 on the
//     MUFU) while the tensor cores work on the second; P is packed into
//     the A registers once that product is done with them. Between the
//     two consumer warpgroups, ping-pong (FA-3's): named barriers make
//     them take turns at issuing their products, so one's softmax
//     overlaps the other's wgmmas.
//   * Masking. Whole kv tiles dead under the TPU kernel's liveness rule
//     (flash_attention.py:48-53, at this kernel's 128 x 128 tiles) are
//     never loaded; within a consumer's 64 rows only tiles on the causal
//     diagonal, on the window's edge or past Skv are masked element-wise.
//   * Output: acc / max(l, 1e-30), rounded to bf16 and stored straight from
//     registers; rows past Sq are not stored.
//
// Numbers. q and k enter the first product as the bf16 values they are;
// their products are exact and summed in float32, and S is scaled in
// float32 afterwards (by scale * log2(e), so that the softmax runs on
// ex2.approx, whose ~2 ulp are far below P's bf16 rounding). The Pallas
// kernel's `q.astype(f32) * scale` followed by an f32 dot on the TPU's
// matrix unit at default precision rounds the scaled q to bf16 instead.
// P is rounded to bf16 for the second product, as FA-2/3 do; its row sum
// is taken in float32 before rounding. The finite NEG_INF is kept (applied
// after scaling): a row whose first live tile is fully masked accumulates
// exp2(0) = 1 terms, wiped by alpha = 0 when its first visible key
// arrives, as in the reference. Built without --use_fast_math.
//
// The tensor maps are encoded on the host with the driver's
// cuTensorMapEncodeTiled, reached through the runtime's
// cudaGetDriverEntryPoint(ByVersion) so that the plain `nvcc -shared` build
// of kernels/_build.py needs no -lcuda, and passed as __grid_constant__
// kernel parameters.

#include <cuda.h>            // CUtensorMap and its enums; no driver calls
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr float LOG2E = 1.44269504088896340736f;
constexpr int BQ = 128;        // query rows per CTA
constexpr int BK = 128;        // keys per kv tile
constexpr int STAGES = 3;      // kv ring depth
constexpr int CONSUMERS = 2;   // consumer warpgroups, 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int CHUNK = 64;      // bf16 columns of one 128-byte swizzled row
constexpr int ROW_BYTES = 128;

template <int D>
struct Layout {
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;   // one K or V stage
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // q_full, q_empty, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr int BARS = 2 + 3 * STAGES;
  // + 1024: the dynamic base is aligned up to the swizzle's 1024 bytes.
  static constexpr int SMEM = BAR_OFF + 8 * BARS + 1024;
};

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
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

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head)
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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups of this thread are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Tie registers to this point: placed after a wait, it keeps the compiler
// from reading an accumulator before the wgmma that writes it completes,
// and from reusing A-fragment registers that a wgmma still reads.
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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[0:64] (+)= A[64 x 16] . B[128 x 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:32] += A[64 x 16] (registers) . B[16 x 64], B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[0:64] += A[64 x 16] (registers) . B[16 x 128], B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&acc)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&acc)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(acc, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&acc)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(acc, a, db);
}

// S = Q K^T for one warpgroup's 64 rows: D / 16 wgmma k-steps, committed
// as one group (the caller fences and waits).
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t q_wg,
                                         uint32_t k_st) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t chunk = kk / 4, col = (kk % 4) * 32;
    wgmma_ss_n128(sc, sw128_desc(q_wg + chunk * BQ * ROW_BYTES + col, 16, 1024),
                  sw128_desc(k_st + chunk * BK * ROW_BYTES + col, 16, 1024),
                  kk > 0);
  }
  wgmma_commit();
}

// O += P V for one warpgroup: BK / 16 wgmma k-steps, V MN-major, committed
// as one group.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_st) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_pv<D>(acc, pa[kk],
                sw128_desc(v_st + kk * 16 * ROW_BYTES, BK * ROW_BYTES, 1024));
  wgmma_commit();
}

// One kv tile's online-softmax step on the score accumulator, in place.
// Element 4j + e of `sc` is row row_lo + 8 (e / 2), key k0 + 8 j + col_in +
// e % 2. Scales (by scale * log2 e) and masks, updates the running max m
// and the thread's partial row sums l of its two rows, leaves P (float32)
// in `sc`, and returns in alpha the factor by which the output rows must
// be rescaled.
__device__ __forceinline__ void softmax_step(
    float (&sc)[BK / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    bool masked, int k0, int row_lo, int col_in, int Skv, int causal,
    int window, float scale_log2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = sc[4 * j + e] * scale_log2;
      if (masked) {
        const int kp = k0 + 8 * j + col_in + (e & 1);
        const int qp = row_lo + 8 * (e >> 1);
        bool ok = kp < Skv;
        if (causal) ok = ok && kp <= qp;
        if (window) ok = ok && qp - kp < window;
        if (!ok) v = NEG_INF;
      }
      sc[4 * j + e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    sc[i] = ex2(sc[i] - m[(i >> 1) & 1]);
    l[(i >> 1) & 1] += sc[i];
  }
}

// P (float32, the accumulator's layout) to bf16 wgmma A fragments: 16-key
// slice kk holds n8 blocks 2 kk (registers 0, 1: rows lo, hi) and 2 kk + 1
// (registers 2, 3).
__device__ __forceinline__ void pack_p(const float (&sc)[BK / 2],
                                       uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * kk + h;
      pa[kk][2 * h] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
      pa[kk][2 * h + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
    }
  }
}

// The live kv tiles [t0, t1) of the q tile at q0: the TPU kernel's
// whole-tile liveness rule at BQ x BK tiles.
__device__ __forceinline__ void kv_tiles(int q0, int Skv, int causal,
                                         int window, int& t0, int& t1) {
  t1 = (Skv + BK - 1) / BK;
  if (causal) t1 = min(t1, (q0 + BQ - 1) / BK + 1);
  t0 = 0;
  if (window) {
    const int x = q0 - window - BK + 1;   // tiles starting at <= x are dead
    if (x >= 0) t0 = x / BK + 1;
  }
  t0 = min(t0, t1);
}

// Work item r of CTA c of G, in snake order over the items sorted heaviest
// first: round r takes items [r G, r G + G), forwards on even rounds and
// backwards on odd ones, which balances the causal tiles' uneven work
// across the persistent CTAs about as well as a dynamic scheduler would.
__device__ __forceinline__ int item_of(int r, int c, int G) {
  return r * G + ((r & 1) ? G - 1 - c : c);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               __nv_bfloat16* __restrict__ o, int BH, int Sq, int Skv,
               int group, int causal, int window, float scale_log2) {
  using L = Layout<D>;
  constexpr int CH = D / CHUNK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::Q_OFF;
  const uint32_t k_s = base + L::K_OFF;
  const uint32_t v_s = base + L::V_OFF;
  const uint32_t q_full = base + L::BAR_OFF;
  const uint32_t q_empty = q_full + 8u;
  auto k_full = [&](int s) { return q_full + 8u * (2 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (2 + STAGES + s); };
  auto empty = [&](int s) { return q_full + 8u * (2 + 2 * STAGES + s); };

  // Items are (q tile, head) pairs, heaviest q tiles first; the heads that
  // share a kv head sit side by side.
  const int nq = (Sq + BQ - 1) / BQ, items = nq * BH;
  auto decode = [&](int it, int& bh, int& q0) {
    bh = it % BH;
    q0 = (nq - 1 - it / BH) * BQ;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMERS * 128);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---- producer warpgroup: one thread keeps the TMA ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      int n = 0;                          // kv tiles loaded so far
      for (int r = 0;; ++r) {
        const int it = item_of(r, blockIdx.x, gridDim.x);
        if (it >= items) break;
        int bh, q0, t0, t1;
        decode(it, bh, q0);
        kv_tiles(q0, Skv, causal, window, t0, t1);
        // Q is single-buffered: wait until both consumers are done with
        // the previous item's (their last S = Q K^T has completed).
        if (r > 0) mbar_wait(q_empty, (r - 1) & 1);
        mbar_expect_tx(q_full, L::Q_BYTES);
        for (int c = 0; c < CH; ++c)
          tma_load(q_s + c * BQ * ROW_BYTES, &q_map, q_full, c * CHUNK, q0,
                   bh);
        const int kvh = bh / group;
        for (int t = t0; t < t1; ++t, ++n) {
          const int s = n % STAGES;
          mbar_wait(empty(s), ((n / STAGES) & 1) ^ 1);
          mbar_expect_tx(k_full(s), L::KV_BYTES);
          for (int c = 0; c < CH; ++c)
            tma_load(k_s + s * L::KV_BYTES + c * BK * ROW_BYTES, &k_map,
                     k_full(s), c * CHUNK, t * BK, kvh);
          mbar_expect_tx(v_full(s), L::KV_BYTES);
          for (int c = 0; c < CH; ++c)
            tma_load(v_s + s * L::KV_BYTES + c * BK * ROW_BYTES, &v_map,
                     v_full(s), c * CHUNK, t * BK, kvh);
        }
      }
    }
  } else {
    // ---- consumer warpgroup: 64 query rows of each item ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int col_in = (lane % 4) * 2;
    const uint32_t q_wg = q_s + wg * 64 * ROW_BYTES;
    // Ping-pong: the two consumer warpgroups take turns at issuing their
    // products (named barrier 1 + wg is this warpgroup's turn; each turn
    // ends by passing it to the other), so one's softmax overlaps the
    // other's wgmmas. Per item, warpgroup 0 goes first; both have
    // t1 - t0 + 1 turns, and warpgroup 1 passes after all but its last.
    auto take_turn = [&]() {
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
    };
    auto pass_turn = [&]() {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
    };
    int n = 0;                            // kv tiles consumed so far
    for (int r = 0;; ++r) {
      const int it = item_of(r, blockIdx.x, gridDim.x);
      if (it >= items) break;
      int bh, q0, t0, t1;
      decode(it, bh, q0);
      kv_tiles(q0, Skv, causal, window, t0, t1);
      const int qw = q0 + wg * 64;                        // my first row
      const int row_lo = qw + (tid / 32) * 16 + lane / 4;  // and row_lo + 8
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
      // Only tiles on the causal diagonal, on the window's edge or past
      // Skv are masked element-wise (uniform over the warpgroup).
      auto masked = [&](int k0) {
        return k0 + BK > Skv || (causal && k0 + BK - 1 > qw) ||
               (window && qw + 63 - k0 >= window);
      };

      // Software pipeline over the item's kv tiles (kv tile t is the ring's
      // tile n + t - t0): one step issues tile t's S = Q K^T and tile
      // t - 1's O += P V back to back, waits for the first only, and runs
      // tile t's softmax on the CUDA cores while the tensor cores finish
      // the second; P is packed into the A registers once that product is
      // done with them (one register set, as FA-3 does). O's rescale and
      // P's registers are pinned ahead of the step's wgmma.fence: a
      // register that a wgmma reads, defined inside its pipeline stage,
      // makes ptxas serialize the wgmmas.
      mbar_wait(q_full, r & 1);
      if (t0 < t1) {
        uint32_t pa[BK / 16][4];
        float alpha[2];
        if (wg == 1) pass_turn();
        {
          float sc[BK / 2];
          const int s = n % STAGES;
          mbar_wait(k_full(s), (n / STAGES) & 1);
          take_turn();
          wgmma_fence();
          issue_qk<D>(sc, q_wg, k_s + s * L::KV_BYTES);
          pass_turn();
          wgmma_wait<0>();
          fence_regs(sc);
          if (t1 - t0 == 1) mbar_arrive(q_empty);   // done with Q
          softmax_step(sc, m, l, alpha, masked(t0 * BK), t0 * BK, row_lo,
                       col_in, Skv, causal, window, scale_log2);
          pack_p(sc, pa);
        }
        for (int t = t0 + 1; t < t1; ++t) {
          const int j = n + t - t0, s = j % STAGES, sp = (j - 1) % STAGES;
          float sc[BK / 2];
          mbar_wait(k_full(s), (j / STAGES) & 1);
          mbar_wait(v_full(sp), ((j - 1) / STAGES) & 1);
#pragma unroll
          for (int i2 = 0; i2 < D / 2; ++i2) acc[i2] *= alpha[(i2 >> 1) & 1];
          fence_regs(acc);
          fence_regs(pa);
          take_turn();
          wgmma_fence();
          issue_qk<D>(sc, q_wg, k_s + s * L::KV_BYTES);
          issue_pv<D>(acc, pa, v_s + sp * L::KV_BYTES);
          pass_turn();
          wgmma_wait<1>();               // S of tile t is in
          fence_regs(sc);
          if (t == t1 - 1) mbar_arrive(q_empty);    // done with Q
          softmax_step(sc, m, l, alpha, masked(t * BK), t * BK, row_lo,
                       col_in, Skv, causal, window, scale_log2);
          wgmma_wait<0>();               // O += P V of tile t - 1 is in
          fence_regs(acc);
          fence_regs(pa);
          mbar_arrive(empty(sp));
          pack_p(sc, pa);
        }
        const int j = n + t1 - 1 - t0, s = j % STAGES;
#pragma unroll
        for (int i2 = 0; i2 < D / 2; ++i2) acc[i2] *= alpha[(i2 >> 1) & 1];
        mbar_wait(v_full(s), (j / STAGES) & 1);
        fence_regs(acc);
        fence_regs(pa);
        take_turn();
        wgmma_fence();
        issue_pv<D>(acc, pa, v_s + s * L::KV_BYTES);
        if (wg == 0) pass_turn();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
        mbar_arrive(empty(s));
        n += t1 - t0;
      } else {
        mbar_arrive(q_empty);
      }

      float den[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
        den[rr] = fmaxf(l[rr], 1e-30f);
      }
      __nv_bfloat16* oh = o + static_cast<size_t>(bh) * Sq * D;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = row_lo + 8 * rr;
        if (row >= Sq) continue;
        __nv_bfloat16* orow = oh + static_cast<size_t>(row) * D + col_in;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[4 * jj + 2 * rr] / den[rr],
              acc[4 * jj + 2 * rr + 1] / den[rr]);
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj) = v;
        }
      }
    }
  }
}

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

// A [heads, rows, D] bf16 tensor as a 3-D map, boxes of 64 columns x
// box_rows rows x 1 head, 128-byte swizzle, out-of-bounds rows read as 0.
int make_map(CUtensorMap* map, const void* ptr, int D, int rows, int heads,
             int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return NO_ENCODER;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {CHUNK, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + static_cast<int>(r);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int Sq, int Skv, int group, int causal, int window, float scale,
           cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  int err = make_map(&q_map, q, D, Sq, BH, BQ);
  if (err == 0) err = make_map(&k_map, k, D, Skv, BH / group, BK);
  if (err == 0) err = make_map(&v_map, v, D, Skv, BH / group, BK);
  if (err != 0) return err;
  const int smem = Layout<D>::SMEM;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_fwd_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  static int sms = 0;                   // one persistent CTA per SM
  if (sms == 0) {
    int dev = 0;
    if ((cerr = cudaGetDevice(&dev)) != cudaSuccess ||
        (cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev)) != cudaSuccess)
      return static_cast<int>(cerr);
  }
  const int items = BH * ((Sq + BQ - 1) / BQ);
  flash_fwd_sm90<D><<<items < sms ? items : sms, THREADS, smem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), BH, Sq, Skv,
      group, causal, window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// o [BH, Sq, D] from q [BH, Sq, D] and k, v [BH / group, Skv, D], all
// bfloat16, contiguous, 16-byte aligned, on the current device; D in
// {64, 128}. causal and window as in the reference (window 0: none).
// Launches on `stream`; returns 0 on success, a CUDA error code, or
// 10000 (no cuTensorMapEncodeTiled) / 20000 + CUresult (a tensor map was
// refused).
int flash_attention_fwd_sm90(const void* q, const void* k, const void* v,
                             void* o, int BH, int Sq, int Skv, int D,
                             int group, int causal, int window, float scale,
                             cudaStream_t stream) {
  if (group < 1 || BH % group != 0 || Sq < 1 || Skv < 1 || BH < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64: return launch<64>(q, k, v, o, BH, Sq, Skv, group, causal,
                               window, scale, stream);
    case 128: return launch<128>(q, k, v, o, BH, Sq, Skv, group, causal,
                                 window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
