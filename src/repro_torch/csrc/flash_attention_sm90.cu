// Flash attention (forward) on Hopper's tensor cores, bf16 in and out, at
// head dims (D_qk, D_v) of (64, 64), (128, 128), (256, 256) and MLA's
// (96, 64) and (192, 128): wgmma for both products, TMA for every tile,
// one producer warp and two consumer warpgroups per CTA (sm_90a).
//
// Replaces: repro/kernels/flash_attention/flash_attention.py::
// flash_attention_bh (the Pallas TPU kernel, `_kernel`), for bf16 inputs
// at those head dims; float32 inputs, and bf16 at D 16, keep the scalar
// kernel of flash_attention.cu. For each query head h and query row i,
// with kv head h / group:
//
//   o_i = sum_j softmax_j(scale * q_i . k_j + mask_ij) v_j
//
// where mask_ij is 0 where key j is visible to query i (j < Skv; causal:
// j <= i + q_off; sliding: also i + q_off - j < window) and NEG_INF = -2e38
// elsewhere. q_off is the first query's position counted from the first key:
// 0 for a whole sequence, r S / n for segment r of a sequence split n ways
// (context parallelism: a segment's queries against its prefix's keys). v's
// head dim may differ from q's and k's (MLA: q and k carry d_nope + d_rope
// columns, v d_v; reference repro/models/mla.py, scale 1 / sqrt(D_qk)).
//
// Layout. q [B, Sq, Hq, D_qk], k [B, Skv, Hkv, D_qk], v [B, Skv, Hkv, D_v]
// and o [B, Sq, Hq, D_v] are read and written where the caller has them,
// at any batch, row and head strides that are multiples of 16 bytes (the
// model's own layout, a strided view of it, or heads-first [BH, S, D] as
// batch 1 with a head stride of S * D): no copy before or after.
//
// Bound. At qwen2-1.5B prefill (B 4, S 2048, 12 q heads over 2 kv heads,
// D 128, causal) the two products are 51.5 GFLOP over the causal triangle:
// 52 us at the bf16 tensor-core peak (989 TFLOP/s, H100 SXM data sheet,
// 700 W); q, k, v read once and o written once are 59 MB, 18 us at
// 3.35 TB/s. At D 256 (the gemma prefills, B 4, S 2048): gemma3-4B's 32 q
// heads over 16 kv heads are 51.6 GFLOP under its 1024-key window (52 us)
// and 68.7 GFLOP causal on its global layers (70 us), with 101 MB (30 us);
// recurrentgemma-2B's 40 over 4 (window 2048 = S) 85.9 GFLOP (87 us), 101
// MB. MLA (B 4, S 2048, causal, one kv head a q head): minicpm3-4B's 40
// heads at (96, 64) are 107.4 GFLOP (109 us), 210 MB (63 us); DeepSeek-
// V2's 128 at (192, 128) 687.5 GFLOP (695 us), 1342 MB (401 us).
// Operations bound every one, so the products must run on wgmma.
//
// Design.
//   * Persistent CTAs: one per SM (fewer if there are fewer items), each
//     walking work items (batch and q head, q tile of BQ = 128 rows). Where
//     every head's K and V fit in L2 together, items are ordered heaviest
//     causal q tile first, the heads that share a kv head side by side,
//     and dealt to the CTAs in snake order (forwards, then backwards,
//     round by round), which balances the causal work about as well as
//     the hardware's dynamic scheduling of one CTA per item did. Where
//     they do not (the launcher compares their bytes with the card's L2
//     size), that order has each round take one q tile of every head, so
//     K and V come from device memory once per q tile: at DeepSeek-V2's
//     MLA (671 MB of K and V) 2.2 ms a call against 1.5 ms with pairs of
//     q tiles, t and nq - 1 - t (the same causal work in every pair),
//     dealt head by head, both tiles of a pair to one CTA, so that the
//     CTAs at work share a few heads' K and V (kernel_probe.py ab, NVIDIA
//     H100 80GB HBM3, 700 W; where K and V fit, pairs ran up to 17 %
//     slower for want of balance). The order changes no item's
//     arithmetic. Staying resident, a CTA loads the next item's Q and
//     first K and V tiles while it finishes the current one, where a
//     fresh CTA would wait for them.
//   * Tile traits by head dims (`Tiles<D_qk, D_v>`): BK keys a kv tile,
//     STAGES in the kv ring. (64, 64), (128, 128), (96, 64): BK 128, 3
//     stages. (256, 256): BK 64, 2 stages; (192, 128): BK 128, 2 stages;
//     both with K released apart from V (below). BK 64 and 3 stages at
//     (192, 128), and BK 64 at (96, 64), ran within 2 % of these
//     (kernel_probe.py ab, NVIDIA H100 80GB HBM3, 700 W).
//   * Three warpgroups. Warpgroup 2 is the producer: after `setmaxnreg` has
//     cut it to 24 registers, one thread issues TMA loads
//     (cp.async.bulk.tensor.4d, completion on an mbarrier) of each item's Q
//     (single-buffered: it waits for both consumers' `q_empty`) and of the
//     K and V tiles into the ring of STAGES stages that runs on across
//     items, waiting on each stage's `empty` barrier before it reuses it.
//     K and V have barriers of their own, so S = Q K^T starts before V
//     lands. With two stages a stage's K has its own `k_empty` too,
//     arrived on as soon as S = Q K^T has read it: K of tile t + 1 then
//     loads while tile t - 1's V is still in use, where one release per
//     stage held it back until both warpgroups had finished O += P V of
//     tile t - 1 (8-15 % of the gemma calls' time, kernel_probe.py ab).
//     Warpgroups 0 and 1 are consumers (240 registers each), 64 query rows
//     apiece: wgmma's M.
//   * Tensor maps are 4-D, (columns, heads, rows, batch) over the caller's
//     element strides, with boxes of 64 columns x 1 head x BQ or BK rows
//     x 1 batch, so a tile never crosses into another head or batch: rows
//     past Sq or Skv, and columns past D_qk, are filled with zeros by TMA.
//     Boxes are 64 columns (128 bytes) wide with the 128-byte swizzle; a
//     row of Q or K is ceil(D_qk / 64) such boxes and a row of V D_v / 64,
//     kept as [rows][64] column chunks (a D 256 tile takes four box loads
//     a tensor). At D_qk 96 the second chunk's columns 96-127 are zero fill
//     that the k loop never reaches. The wgmma descriptors use the same
//     swizzle: Q and K are K-major (D contiguous; SBO = 1024 bytes between
//     8-row groups, a 16-column k step advances the start by 32 bytes
//     inside a chunk), V is MN-major for the second product (transposed B;
//     LBO = the chunk stride BK * 128 bytes, so one wgmma of N = D_v reads
//     all D_v / 64 chunks in order; SBO = 1024 bytes, a 16-key k step
//     advances by 16 rows).
//   * S = Q K^T: D_qk / 16 wgmma.m64n{BK}k16 (bf16 from shared memory,
//     float32 accumulator, BK / 2 floats a thread): six at D_qk 96, twelve
//     at 192. The online softmax runs on that accumulator in registers: a
//     thread holds two rows, each spread over the 4 threads of a quad, so
//     a row max is two __shfl_xor_sync steps; the row sum stays per thread
//     until the end.
//   * O += P V: P is rounded to bf16 in registers and fed as wgmma's A
//     operand from registers (the accumulator's layout of a 16-key slice is
//     the A fragment's), BK / 16 wgmma.m64n{D_v}k16 with V from shared
//     memory (at D_v 256, N 256: wgmma's widest); O (D_v / 2 floats a
//     thread) is rescaled in registers.
//   * Software pipeline within a warpgroup: each step issues tile t's
//     S = Q K^T and tile t - 1's O += P V back to back, waits for the
//     first only, and runs tile t's softmax on the CUDA cores (exp2 on the
//     MUFU) while the tensor cores work on the second; P is packed into
//     the A registers once that product is done with them. Between the
//     two consumer warpgroups, ping-pong (FA-3's): named barriers make
//     them take turns at issuing their products, so one's softmax
//     overlaps the other's wgmmas.
//   * Masking. Whole kv tiles dead under the TPU kernel's liveness rule
//     (flash_attention.py:48-53, at this kernel's 128 x BK tiles, the q
//     tile at its global position q0 + q_off) are never loaded; within a
//     consumer's 64 rows only tiles on the causal diagonal, on the
//     window's edge or past Skv are masked element-wise,
//     by a softmax instantiation of their own (MASK_APART): with the mask's
//     integer arithmetic compiled into the one softmax, calls took up to
//     9 % more (none at D 256; kernel_probe.py ab, NVIDIA H100 80GB HBM3,
//     700 W). The D 256 tiles keep the one softmax (registers).
//     gemma3's global layers pass the reference's BIG_WINDOW (2^30):
//     `q0 - window - BK + 1` and `qp - kp < window` stay in int32 (with an
//     offset of up to 2^29 positions).
//   * An offset moves only the mask and the live tile range: the items, the
//     heaviest-first order (a later q tile still has more live kv tiles)
//     and the pairs (tiles t and nq - 1 - t still hold as much work
//     together as any other pair) are those of offset 0, so every q tile is
//     visited and every live kv tile of it loaded; at offset 0 every
//     instruction's operands are the ones without it.
//   * Output: acc / max(l, 1e-30), rounded to bf16 and stored straight from
//     registers at o's strides; rows past Sq are not stored. The quotient
//     takes one correctly rounded reciprocal a row and a Markstein
//     correction an element (`quotient`), bit for bit the IEEE division it
//     replaced, which a clock64-instrumented build found to be the larger
//     part of an item's epilogue. With the softmax split
//     above, up to 13 % off a call, 1 % at recurrentgemma-2B's
//     (kernel_probe.py ab, NVIDIA H100 80GB HBM3, 700 W; max |d| 0
//     against the parent at every shape).
//
// Budgets. Shared memory at (256, 256): Q 128 x 256 x 2 = 65,536 B, K and
// V 2 stages x 2 x 64 x 256 x 2 = 131,072 B, 10 barriers 80 B and the
// 1,024 B swizzle alignment: 197,712 B of a block's 232,448. At (192,
// 128): Q 128 x 192 x 2 = 49,152 B, 2 stages of K (49,152 B) and V
// (32,768 B), 80 B, 1,024 B: 214,096 B (three such stages do not fit). At
// (96, 64): Q 32,768 B (two chunks, the second half zero fill), 3 stages
// of K (32,768 B) and V (16,384 B), 11 barriers 88 B, 1,024 B: 181,336 B.
// Registers: a consumer holds O (D_v / 2 floats: 128 at D_v 256), tile
// t's S (BK / 2), tile t - 1's P fragments (BK / 4) and the row
// statistics under the 240 that setmaxnreg gives it. ptxas (CUDA 12.8,
// `kernel_probe.py ptxas flash_attention_sm90`) gives all five
// instantiations 168 registers a thread at launch (the cap of 384 threads
// at one CTA an SM, raised for the consumers by setmaxnreg), and 0 bytes of
// spill stores and loads to all but (192, 128), which spills 12 bytes
// (48 bytes of loads) for its second softmax (`Tiles`). FA-3's 80-key
// tile also fits at D 256 (230,480
// B) and ran 2-4 % faster on the gemma shapes (kernel_probe.py ab, NVIDIA
// H100 80GB HBM3, 700 W); the 64-key tile is kept: it needs no n80
// product and leaves no ragged kv tile at S 2048.
//
// Numbers. q and k enter the first product as the bf16 values they are;
// their products are exact and summed in float32, and S is scaled in
// float32 afterwards (by scale * log2(e), so that the softmax runs on
// ex2.approx, whose ~2 ulp are far below P's bf16 rounding): MLA's scale
// is 1 / sqrt(D_qk), applied to the float32 scores as the reference's
// numpy float64 promotes them. The Pallas kernel's `q.astype(f32) * scale`
// followed by an f32 dot on the TPU's matrix unit at default precision
// rounds the scaled q to bf16 instead. P is rounded to bf16 for the
// second product, as FA-2/3 do; its row sum is taken in float32 before
// rounding. The finite NEG_INF is kept (applied after scaling): a row
// whose first live tile is fully masked accumulates exp2(0) = 1 terms,
// wiped by alpha = 0 when its first visible key arrives, as in the
// reference. Built without --use_fast_math.
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
constexpr int CONSUMERS = 2;   // consumer warpgroups, 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int CHUNK = 64;      // bf16 columns of one 128-byte swizzled row
constexpr int ROW_BYTES = 128;

// Tile traits by head dims (DQK: q and k, DV: v): BK keys per kv tile, a
// kv ring of STAGES, whether a stage's K is released apart from its V
// (SPLIT), and whether unmasked tiles take a softmax instantiation without
// the mask (MASK_APART). At D 256 two stages of 64 keys are what fits
// beside Q; at (192, 128) two stages of 128 keys (the header's budgets).
// At both the second softmax makes ptxas spill 12 bytes a thread; at D 256
// it saved nothing (kernel_probe.py ab), so it is left out there, while at
// (192, 128) DeepSeek-V2's call ran 3-12 % faster with it all the same.
template <int DQK, int DV>
struct Tiles {
  static constexpr int BK = 128;
  static constexpr int STAGES = 3;
  static constexpr bool SPLIT = false;
  static constexpr bool MASK_APART = true;
};
template <>
struct Tiles<256, 256> {
  static constexpr int BK = 64;
  static constexpr int STAGES = 2;
  static constexpr bool SPLIT = true;
  static constexpr bool MASK_APART = false;
};
template <>
struct Tiles<192, 128> {
  static constexpr int BK = 128;
  static constexpr int STAGES = 2;
  static constexpr bool SPLIT = true;
  static constexpr bool MASK_APART = true;
};

// Shared memory. A row of Q or K is QK_CHUNKS 64-column chunks (at D_qk 96
// the second chunk's columns 96-127 are TMA's zero fill, never read), a row
// of V is DV / 64; each tile is kept chunk by chunk, [rows][64].
template <int DQK, int DV>
struct Layout {
  static constexpr int BK = Tiles<DQK, DV>::BK;
  static constexpr int STAGES = Tiles<DQK, DV>::STAGES;
  static constexpr bool SPLIT = Tiles<DQK, DV>::SPLIT;
  static constexpr int QK_CHUNKS = (DQK + CHUNK - 1) / CHUNK;
  static constexpr int V_CHUNKS = DV / CHUNK;
  static constexpr int Q_BYTES = BQ * QK_CHUNKS * ROW_BYTES;
  static constexpr int K_BYTES = BK * QK_CHUNKS * ROW_BYTES;   // a K stage
  static constexpr int V_BYTES = BK * V_CHUNKS * ROW_BYTES;    // a V stage
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * K_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * V_BYTES;
  // q_full, q_empty, k_full[STAGES], v_full[STAGES], empty[STAGES]
  // (+ k_empty[STAGES] where SPLIT: empty then releases V alone)
  static constexpr int BARS = 2 + (SPLIT ? 4 : 3) * STAGES;
  // + 1024: the dynamic base is aligned up to the swizzle's 1024 bytes.
  static constexpr int SMEM = BAR_OFF + 8 * BARS + 1024;
  static_assert(DQK % 16 == 0 && DV % CHUNK == 0, "unsupported head dims");
  static_assert(SMEM <= 232448, "more shared memory than a block has");
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

// One box of a 4-D (D, heads, rows, batch) map: columns [col, col + 64) of
// rows [row, row + box rows) of one head of one batch.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
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

// d[0:32] (+)= A[64 x 16] . B[64 x 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
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

// d[0:128] += A[64 x 16] (registers) . B[16 x 256], B MN-major in shared
// memory (four 64-column chunks, LBO apart)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
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
template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&acc)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n256(acc, a, db);
}

// One k-step of S = Q K^T over a BK-key tile.
template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&sc)[BK / 2], uint64_t da,
                                         uint64_t db, int accumulate);
template <>
__device__ __forceinline__ void wgmma_qk<64>(float (&sc)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  wgmma_ss_n64(sc, da, db, accumulate);
}
template <>
__device__ __forceinline__ void wgmma_qk<128>(float (&sc)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  wgmma_ss_n128(sc, da, db, accumulate);
}

// S = Q K^T for one warpgroup's 64 rows: DQK / 16 wgmma k-steps, committed
// as one group (the caller fences and waits). A row of Q or K is a run of
// swizzled 64-column chunks; four k-steps walk one chunk (at DQK 96 the
// sixth step ends halfway through the second, before its zero fill).
template <int DQK, int BK>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t q_wg,
                                         uint32_t k_st) {
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk) {
    const uint32_t chunk = kk / 4, col = (kk % 4) * 32;
    wgmma_qk<BK>(sc,
                 sw128_desc(q_wg + chunk * BQ * ROW_BYTES + col, 16, 1024),
                 sw128_desc(k_st + chunk * BK * ROW_BYTES + col, 16, 1024),
                 kk > 0);
  }
  wgmma_commit();
}

// O += P V for one warpgroup: BK / 16 wgmma k-steps, V MN-major (its DV / 64
// column chunks LBO = BK * ROW_BYTES apart, read by one wgmma of N = DV),
// committed as one group.
template <int DV, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[DV / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_st) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_pv<DV>(acc, pa[kk],
                 sw128_desc(v_st + kk * 16 * ROW_BYTES, BK * ROW_BYTES, 1024));
  wgmma_commit();
}

// One kv tile's online-softmax step on the score accumulator, in place.
// Element 4j + e of `sc` is row row_lo + 8 (e / 2) (global positions: the
// offset added), key k0 + 8 j + col_in + e % 2. Scales (by scale * log2 e) and, where MASKED and `masked`, masks,
// updates the running max m and the thread's partial row sums l of its two
// rows,
// leaves P (float32) in `sc`, and returns in alpha the factor by which the
// output rows must be rescaled.
template <int BK, bool MASKED>
__device__ __forceinline__ void softmax_step(
    float (&sc)[BK / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    int k0, int row_lo, int col_in, int Skv, int causal, int window,
    float scale_log2, bool masked) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = sc[4 * j + e] * scale_log2;
      if (MASKED && masked) {
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

// a / b, correctly rounded, from y = 1 / b correctly rounded (Markstein's
// theorem): q = a y is within an ulp of a / b, the FMA gives its residual
// r exactly, and q + r y rounds to a / b wherever a / b is a normal float
// or 0 (an output here is a weighted mean of bf16 values; b is in [1e-30,
// Skv]). One reciprocal a row replaces an IEEE division an element.
__device__ __forceinline__ float quotient(float a, float b, float y) {
  const float q = __fmul_rn(a, y);
  return __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
}

// P (float32, the accumulator's layout) to bf16 wgmma A fragments: 16-key
// slice kk holds n8 blocks 2 kk (registers 0, 1: rows lo, hi) and 2 kk + 1
// (registers 2, 3).
template <int BK>
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

// The live kv tiles [t0, t1) of the q tile at global position q0 (its
// local first row plus the offset): the TPU kernel's whole-tile liveness
// rule at BQ x BK tiles.
template <int BK>
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

// o [B, Sq, Hq, DV] at element strides (o_sb, o_ss, o_sh), unit column
// stride; q, k and v come in through their tensor maps.
template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               __nv_bfloat16* __restrict__ o, int64_t o_sb, int64_t o_ss,
               int64_t o_sh, int B, int Hq, int Sq, int Skv, int group,
               int causal, int window, int q_off, float scale_log2,
               int by_pairs) {
  using L = Layout<DQK, DV>;
  constexpr int BK = L::BK, STAGES = L::STAGES;
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
  auto k_empty = [&](int s) { return q_full + 8u * (2 + 3 * STAGES + s); };

  // Work item j of this CTA, a (batch, head, q tile): returns 1 and sets
  // (b, h, q0), or 0 past its last item, or -1 for no item (skipped).
  // Heads that share a kv head sit side by side in both orders.
  const int BH = B * Hq;
  const int nq = (Sq + BQ - 1) / BQ, half = (nq + 1) / 2;
  const int G = gridDim.x, cta = blockIdx.x;
  auto decode = [&](int j, int& b, int& h, int& q0) -> int {
    int bh, qt;
    if (by_pairs) {
      // Pair p of head bh is q tiles nq - 1 - p and p (as much causal
      // work as any other pair), both taken by one CTA, heavier first;
      // pairs are dealt head by head, so the CTAs at work share few
      // heads' K and V and those stay in L2. An odd nq's middle tile has
      // no partner.
      const int P = (j >> 1) * G + cta;
      if (P >= BH * half) return 0;
      bh = P / half;
      const int p = P % half;
      qt = (j & 1) ? p : nq - 1 - p;
      if ((j & 1) && qt == nq - 1 - p) return -1;
    } else {
      const int it = item_of(j, cta, G);
      if (it >= nq * BH) return 0;
      bh = it % BH;
      qt = nq - 1 - it / BH;
    }
    b = bh / Hq;
    h = bh % Hq;
    q0 = qt * BQ;
    return 1;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMERS * 128);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), CONSUMERS * 128);
      if (L::SPLIT) mbar_init(k_empty(s), CONSUMERS * 128);
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
      for (int j = 0, r = -1;; ++j) {
        int b, h, q0, t0, t1;
        const int got = decode(j, b, h, q0);
        if (got == 0) break;
        if (got < 0) continue;
        ++r;                              // items loaded so far, less one
        kv_tiles<BK>(q0 + q_off, Skv, causal, window, t0, t1);
        // Q is single-buffered: wait until both consumers are done with
        // the previous item's (their last S = Q K^T has completed).
        if (r > 0) mbar_wait(q_empty, (r - 1) & 1);
        mbar_expect_tx(q_full, L::Q_BYTES);
        for (int c = 0; c < L::QK_CHUNKS; ++c)
          tma_load(q_s + c * BQ * ROW_BYTES, &q_map, q_full, c * CHUNK, h,
                   q0, b);
        const int kvh = h / group;
        for (int t = t0; t < t1; ++t, ++n) {
          const int s = n % STAGES;
          const uint32_t free_parity = ((n / STAGES) & 1) ^ 1;
          mbar_wait(L::SPLIT ? k_empty(s) : empty(s), free_parity);
          mbar_expect_tx(k_full(s), L::K_BYTES);
          for (int c = 0; c < L::QK_CHUNKS; ++c)
            tma_load(k_s + s * L::K_BYTES + c * BK * ROW_BYTES, &k_map,
                     k_full(s), c * CHUNK, kvh, t * BK, b);
          if (L::SPLIT) mbar_wait(empty(s), free_parity);
          mbar_expect_tx(v_full(s), L::V_BYTES);
          for (int c = 0; c < L::V_CHUNKS; ++c)
            tma_load(v_s + s * L::V_BYTES + c * BK * ROW_BYTES, &v_map,
                     v_full(s), c * CHUNK, kvh, t * BK, b);
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
    for (int j = 0, r = -1;; ++j) {
      int b, h, q0, t0, t1;
      const int got = decode(j, b, h, q0);
      if (got == 0) break;
      if (got < 0) continue;
      ++r;                                // items taken so far, less one
      kv_tiles<BK>(q0 + q_off, Skv, causal, window, t0, t1);
      const int qw = q0 + wg * 64;                        // my first row
      const int row_lo = qw + (tid / 32) * 16 + lane / 4;  // and row_lo + 8
      const int gw = qw + q_off, g_lo = row_lo + q_off;   // global positions
      float acc[DV / 2];
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
      // Only tiles on the causal diagonal, on the window's edge or past
      // Skv are masked element-wise (uniform over the warpgroup).
      // Where MASK_APART, the mask's arithmetic is compiled into a second
      // instantiation, so that the unmasked tiles' softmax carries none
      // of it.
      auto softmax = [&](float (&sc)[BK / 2], int k0) {
        const bool masked = k0 + BK > Skv || (causal && k0 + BK - 1 > gw) ||
                            (window && gw + 63 - k0 >= window);
        if (Tiles<DQK, DV>::MASK_APART && !masked)
          softmax_step<BK, false>(sc, m, l, alpha, k0, g_lo, col_in, Skv,
                                  causal, window, scale_log2, false);
        else
          softmax_step<BK, true>(sc, m, l, alpha, k0, g_lo, col_in, Skv,
                                 causal, window, scale_log2, masked);
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
        if (wg == 1) pass_turn();
        {
          float sc[BK / 2];
          const int s = n % STAGES;
          mbar_wait(k_full(s), (n / STAGES) & 1);
          take_turn();
          wgmma_fence();
          issue_qk<DQK, BK>(sc, q_wg, k_s + s * L::K_BYTES);
          pass_turn();
          wgmma_wait<0>();
          fence_regs(sc);
          if (L::SPLIT) mbar_arrive(k_empty(s));
          if (t1 - t0 == 1) mbar_arrive(q_empty);   // done with Q
          softmax(sc, t0 * BK);
          pack_p<BK>(sc, pa);
        }
        for (int t = t0 + 1; t < t1; ++t) {
          const int j = n + t - t0, s = j % STAGES, sp = (j - 1) % STAGES;
          float sc[BK / 2];
          mbar_wait(k_full(s), (j / STAGES) & 1);
          mbar_wait(v_full(sp), ((j - 1) / STAGES) & 1);
#pragma unroll
          for (int i2 = 0; i2 < DV / 2; ++i2) acc[i2] *= alpha[(i2 >> 1) & 1];
          fence_regs(acc);
          fence_regs(pa);
          take_turn();
          wgmma_fence();
          issue_qk<DQK, BK>(sc, q_wg, k_s + s * L::K_BYTES);
          issue_pv<DV, BK>(acc, pa, v_s + sp * L::V_BYTES);
          pass_turn();
          wgmma_wait<1>();               // S of tile t is in
          fence_regs(sc);
          if (L::SPLIT) mbar_arrive(k_empty(s));
          if (t == t1 - 1) mbar_arrive(q_empty);    // done with Q
          softmax(sc, t * BK);
          wgmma_wait<0>();               // O += P V of tile t - 1 is in
          fence_regs(acc);
          fence_regs(pa);
          mbar_arrive(empty(sp));
          pack_p<BK>(sc, pa);
        }
        const int j = n + t1 - 1 - t0, s = j % STAGES;
#pragma unroll
        for (int i2 = 0; i2 < DV / 2; ++i2) acc[i2] *= alpha[(i2 >> 1) & 1];
        mbar_wait(v_full(s), (j / STAGES) & 1);
        fence_regs(acc);
        fence_regs(pa);
        take_turn();
        wgmma_fence();
        issue_pv<DV, BK>(acc, pa, v_s + s * L::V_BYTES);
        if (wg == 0) pass_turn();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
        mbar_arrive(empty(s));
        n += t1 - t0;
      } else {
        mbar_arrive(q_empty);
      }

      float den[2], inv[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
        l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
        den[rr] = fmaxf(l[rr], 1e-30f);
        inv[rr] = __frcp_rn(den[rr]);
      }
      __nv_bfloat16* oh = o + b * o_sb + h * o_sh;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = row_lo + 8 * rr;
        if (row >= Sq) continue;
        __nv_bfloat16* orow = oh + row * o_ss + col_in;
#pragma unroll
        for (int jj = 0; jj < DV / 8; ++jj) {
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              quotient(acc[4 * jj + 2 * rr], den[rr], inv[rr]),
              quotient(acc[4 * jj + 2 * rr + 1], den[rr], inv[rr]));
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

// A bf16 tensor [batch, rows, heads, cols] at element strides (sb, ss, sh)
// and unit column stride as a 4-D map over (cols, heads, rows, batch),
// boxes of 64 columns x 1 head x box_rows rows x 1 batch, 128-byte swizzle;
// rows past `rows` and columns past `cols` read as 0. A box never crosses
// into another head or batch, whatever the strides.
int make_map(CUtensorMap* map, const void* ptr, int cols, int heads,
             int rows, int batch, const int64_t* strides, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return NO_ENCODER;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[2]) * 2,
                               static_cast<cuuint64_t>(strides[1]) * 2,
                               static_cast<cuuint64_t>(strides[0]) * 2};
  const cuuint32_t box[4] = {CHUNK, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      bytes, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + static_cast<int>(r);
}

// strides: (batch, row, head) element strides of q, k, v and o, in turn.
template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int Hq, int Hkv, const int64_t* strides,
           int causal, int window, int q_off, float scale,
           cudaStream_t stream) {
  constexpr int BK = Tiles<DQK, DV>::BK;
  CUtensorMap q_map, k_map, v_map;
  int err = make_map(&q_map, q, DQK, Hq, Sq, B, strides, BQ);
  if (err == 0) err = make_map(&k_map, k, DQK, Hkv, Skv, B, strides + 3, BK);
  if (err == 0) err = make_map(&v_map, v, DV, Hkv, Skv, B, strides + 6, BK);
  if (err != 0) return err;
  const int smem = Layout<DQK, DV>::SMEM;
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_fwd_sm90<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  static int sms = 0, l2 = 0;           // one persistent CTA per SM
  if (sms == 0) {
    int dev = 0;
    if ((cerr = cudaGetDevice(&dev)) != cudaSuccess ||
        (cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev)) != cudaSuccess ||
        (cerr = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev)) !=
            cudaSuccess)
      return static_cast<int>(cerr);
  }
  // Where every head's K and V together outgrow L2, the heaviest-first
  // order (each round a q tile of every head) reads them from device
  // memory once per q tile; pairs of q tiles dealt head by head read them
  // about once in all.
  const double kv_bytes = 2.0 * B * Hkv * Skv * (DQK + DV);
  const int by_pairs = kv_bytes > l2;
  const int nq = (Sq + BQ - 1) / BQ;
  const int units = B * Hq * (by_pairs ? (nq + 1) / 2 : nq);
  flash_fwd_sm90<DQK, DV><<<units < sms ? units : sms, THREADS, smem,
                            stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), strides[9],
      strides[10], strides[11], B, Hq, Sq, Skv, Hq / Hkv, causal, window,
      q_off, scale * LOG2E, by_pairs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// o [B, Sq, Hq, Dv] from q [B, Sq, Hq, Dqk], k [B, Skv, Hkv, Dqk] and v
// [B, Skv, Hkv, Dv], all bfloat16 on the current device, each at the
// (batch, row, head) element strides in `strides` (q, k, v, o: 12 values)
// with unit column stride; bases 16-byte aligned and q, k, v strides
// multiples of 8 elements (TMA's 16 bytes). Query head h reads kv head
// h / (Hq / Hkv). (Dqk, Dv) in {(64, 64), (128, 128), (256, 256), (96, 64),
// (192, 128)}. causal and window as in the reference (window 0: none);
// q_off >= 0 the first query's position counted from the first key.
// Launches on `stream`; returns 0 on success, a CUDA error code, or 10000
// (no cuTensorMapEncodeTiled) / 20000 + CUresult (a tensor map was
// refused).
int flash_attention_fwd_sm90_strided(const void* q, const void* k,
                                     const void* v, void* o, int B, int Sq,
                                     int Skv, int Hq, int Hkv, int Dqk,
                                     int Dv, const int64_t* strides,
                                     int causal, int window, int q_off,
                                     float scale, cudaStream_t stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv != 0 ||
      q_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define FLASH_DIMS(DQK, DV)                                                 \
  if (Dqk == DQK && Dv == DV)                                               \
    return launch<DQK, DV>(q, k, v, o, B, Sq, Skv, Hq, Hkv, strides, causal, \
                           window, q_off, scale, stream);
  FLASH_DIMS(64, 64)
  FLASH_DIMS(128, 128)
  FLASH_DIMS(256, 256)
  FLASH_DIMS(96, 64)
  FLASH_DIMS(192, 128)
#undef FLASH_DIMS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
