// Hopper (sm_90a) attention forward of prefill: softmax(q k^T * D^-0.5) v
// over (BH, S, D) tensors, with the online softmax of flash attention.
//
// flash_attention_fwd  replaces src/repro/kernels/flash_attention.py:71,
//                       flash_attention_fwd (Pallas _flash_fwd_kernel). A q
//                       tile keeps the running max m (from -1e30), the
//                       running sum l (from 0) and an fp32 accumulator
//                       across kv tiles, rescales them by exp(m_prev - m_new)
//                       at each tile, and ends with acc / max(l, 1e-30), as
//                       the Pallas body does. The causal mask is kv_idx <=
//                       q_idx on absolute indices, with no offset when Sq !=
//                       Skv (the reference's rule). kv tiles wholly above a
//                       q tile's last row are skipped: every row has kv 0
//                       valid, so such a tile would add p = 0 at alpha = 1.
//   The TPU kernel walks the kv grid axis in order on one core and carries
//   (m, l, acc) in VMEM scratch; here a CTA owns a 64-row q tile (or two)
//   and walks its kv tiles itself.
//
// Head dims: every multiple of 16 up to 256, on kernels built at the padded
// widths Dp in {32, 64, 128, 192, 256}; D runs on the least Dp that holds it
// and is the tensor maps' innermost extent at run time, so TMA zero-fills
// columns D .. Dp - 1 of Q, K and V (no bytes read for them) and stores
// only D columns of the output. bf16 computes over Dp (the zero columns add
// nothing; no 64-column box lies wholly past D); fp32 loads and computes
// only the 32-column boxes that hold a column below D.
//
// Bound on this card: bytes at D = 32 (the serve shape, BH 32, S 1024, bf16,
// causal: 8.4 MB of q, k, v and out, 2.5 us at 3.35 TB/s, against 2.15 GFLOP
// of the two products, 2.2 us at 989 TFLOP/s bf16) and at D = 256
// (paligemma-3b's prefill, BH 32, S 384: 25.2 MB, 7.5 us, against 2.4-4.8
// GFLOP), operations at D = 128 (BH 16, S 4096, causal: 68.7 GFLOP, 69 us
// in bf16). What decides the time at D = 32 is neither: the exp of each
// score (one per 2 x 32 multiply-adds) and the chain of kv tiles that the
// last q tile of a causal head walks. At D = 128 with many q tiles, besides
// the tensor cores, the K and V tiles that every CTA reads again from L2
// (1.09 GB at BH 16, S 4096, causal, with 64-row q tiles). At prefill
// shapes of a few hundred rows, the fixed cost of a CTA's first loads and
// its epilogue, and the L2 traffic of every CTA of a head reading its K and
// V.
//
// One design for every type and width. A CTA is one producer warpgroup and
// two consumer warpgroups (384 threads) on one 64-row q tile, or on a
// 128-row one (below):
//   * One producer thread loads Q once, then K and V tile by tile with TMA
//     into a ring of stages in shared memory (as many as fit beside Q, 2 to
//     4), with a K-landed, a V-landed and an empty mbarrier per stage, so
//     Q K^T starts before V lands. The tensor maps are 3-D (D, S, BH), so
//     TMA zero-fills rows past Sq or Skv within a head; the mask is
//     computed only on tiles that cross a warp's diagonal or the end of
//     Skv. Each box is at most 128 bytes wide and written with the matching
//     swizzle (64-byte rows at bf16 Dp = 32, 128-byte rows otherwise; bf16
//     is Dp / 64 boxes of 64 columns, fp32 D / 32 boxes of 32 columns). A
//     kv tile is 64 rows, 32 in fp32 at Dp 192 and 256, where a 64-row
//     stage beside Q would leave room for one.
//   * Registers: nine warps put three on one of the SM's four register
//     files, which caps a thread at 168; a full producer warpgroup that
//     gives its registers up (setmaxnreg, to 32) lets each consumer thread
//     hold 232 (104 at bf16 Dp = 32, two CTAs an SM): the accumulator alone
//     is 128 floats at Dp = 256.
//   * The two consumer warpgroups split the kv walk: warpgroup w takes tiles
//     w, w + 2, ..., so the heaviest q tile's chain of tiles is halved. Each
//     keeps its own (m, l, acc); at the end warpgroup 1 hands its state to
//     warpgroup 0 through shared memory and warpgroup 0 merges the two in a
//     fixed order and writes the output: two launches on the same inputs
//     give the same bits.
//   * bf16 at Dp >= 128, where the 64-row q tiles outnumber the SMs (more
//     than one wave at one CTA per SM), takes 128-row q tiles instead (at
//     Dp 192 and 256 only without the causal mask): each warpgroup owns 64
//     rows and walks every kv tile up to its own last row, and the two
//     share each K and V stage, so the tiles are read from L2 half as
//     often, in half the CTAs; there is no merge.
//   * The grid is one CTA per (q tile, head), ordered heaviest first: the
//     largest q-tile index of every head is scheduled before any smaller
//     one, so where the grid is more than one wave the short causal tiles
//     fill the tail.
//   * Scores are scaled into the log2 domain (exp2); masked scores are -inf,
//     so p is 0 even in a row that a 32-row kv tile masks whole. A warp owns
//     16 q rows; a thread holds the same (row, column) pairs of the score
//     tile and of the output accumulator for both types, so the softmax,
//     the merge and the epilogue are shared.
//   * The epilogue scales each row by one reciprocal of l, writes the tile
//     over the warpgroup's Q tile in the same swizzled box layout, and
//     stores it with TMA, box by box (rows past Sq, columns past D clipped).
//
// The two types:
//   bf16  wgmma. S = Q K^T is wgmma m64n64k16 with A = Q and B = the K tile,
//         both from shared memory, K-major as stored. P V is wgmma with A =
//         P from registers (the score accumulator's layout is the A
//         fragment's) and B = the V tile read MN-major through the
//         descriptor's transpose bit (m64n32k16 at Dp = 32, m64n64k16 per
//         64-column box otherwise). P stays fp32 in the softmax and in l,
//         and enters P V rounded to bf16, as in SDPA. A bf16 hi + lo split
//         of P (16 significant bits, two P V products) was measured against
//         it on the card (PERF.md): largest errors 7.8e-3 against 1.6e-2
//         over the card tests' shapes, both inside the reference's 2e-2
//         band; the serving checks passed with both; P as bf16 alone took
//         0.78x the time at BH 16, S 4096, D 128, causal.
//   fp32  3xTF32 on the tensor cores, mma.sync m16n8k8. Each operand x is
//         split into big = tf32(x) (round to nearest, ties away) and small =
//         x - big, and big*small + small*big + big*big is summed in fp32 for
//         both Q K^T and P V: about 21 significant bits per product, inside
//         the reference's 2e-5 band, where one TF32 product keeps 10. SIMT
//         fp32 FMA would load one shared-memory word per FMA; here one
//         fragment load feeds a 16 x 8 x 8 product, and an A fragment is
//         split once for every B fragment it meets. Fragments are read from
//         the TMA-swizzled tiles without bank conflicts: Q and K in k order
//         (c, c + 4), V in the permuted k order (2c, 2c + 1) that matches the
//         score accumulator's columns, so P needs no shuffle.
//
// The source is built with --fmad=false like the others.
//
// C interface for ctypes; every entry point returns cudaGetLastError(), or
// a CUDA error code when a tensor map cannot be made.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLFloor = 1e-30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFullMask = 0xffffffffu;

constexpr int kTile = 64;                    // rows of a q tile
constexpr int kConsumers = 2;                // warpgroups on alternate kv tiles
constexpr int kThreads = kConsumers * 128 + 128;  // and a producer warpgroup

// Registers a thread: at launch, the share of a CTA of kThreads with
// ``MinBlocks`` CTAs an SM (168 at one); then, after setmaxnreg, the
// producer warpgroup's and the consumers', which take what the producer
// gives up (232 at one CTA an SM, 104 at two).
template <int MinBlocks>
struct Regs {
  static constexpr int kLaunch = (65536 / (kThreads * MinBlocks)) & ~7;
  static constexpr int kProducer = 32;
  static constexpr int kConsumer =
      (kLaunch + (kLaunch - kProducer) * 128 / (kConsumers * 128)) & ~7;
  static_assert(kConsumer <= 256 && kConsumer >= kLaunch, "registers");
};

// Per (element type, padded width Dp): the TMA box width in columns (128
// bytes at most, the widest swizzle), the rows of a kv tile and the CTAs
// wanted per SM. fp32 at Dp 192 and 256 takes 32-row kv tiles: beside Q, a
// 64-row stage of K and V (96 or 128 KB) would leave room for one stage.
template <typename T, int Dp>
struct Cfg;

template <int Dp>
struct Cfg<__nv_bfloat16, Dp> {
  static constexpr int kEs = 2;
  static constexpr int kBoxCols = Dp < 64 ? Dp : 64;
  static constexpr int kKv = 64;
  static constexpr int kMinBlocks = Dp == 32 ? 2 : 1;
};

template <int Dp>
struct Cfg<float, Dp> {
  static constexpr int kEs = 4;
  static constexpr int kBoxCols = 32;
  static constexpr int kKv = Dp > 128 ? 32 : 64;
  static constexpr int kMinBlocks = 1;
};

// QT: 64-row q tiles per CTA (1: the warpgroups split the kv walk of one;
// 2: each warpgroup owns one and walks every kv tile).
template <typename T, int Dp, int QT>
struct Geom {
  using C = Cfg<T, Dp>;
  static constexpr int kRowBytes = C::kBoxCols * C::kEs;   // 64 or 128
  static constexpr int kQBoxBytes = kTile * kRowBytes;
  static constexpr int kKvBoxBytes = C::kKv * kRowBytes;
  static constexpr int kBoxes = Dp / C::kBoxCols;   // per row of a tile
  static constexpr int kQTileBytes = kTile * Dp * C::kEs;
  static constexpr int kKvTileBytes = C::kKv * Dp * C::kEs;
  // the ring: as many stages of a K and a V tile as fit beside Q (the
  // block's 232448 bytes less 1024 to align the base and the barriers), 4
  // at most; at least 2
  static constexpr int kFit =
      (232448 - 1024 - 256 - QT * kQTileBytes) / (2 * kKvTileBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(kStages >= 2, "two stages of K and V");
  static constexpr int kTiles = QT * kQTileBytes + 2 * kStages * kKvTileBytes;
  // Q, then per stage a K tile and a V tile; 1024 bytes to align the base
  static constexpr int kSmem = 1024 + kTiles;
  // the merge's scratch (warpgroup 1's acc, m and l) reuses the tiles
  static_assert((Dp / 2 + 4) * 128 * 4 <= kTiles, "merge scratch does not fit");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spins until the phase of parity ``parity`` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map at (c0, c1, c2) into shared memory; the bytes
// are counted on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// One box of shared memory at src to a 3-D tensor map at (c0, c1, c2),
// as one bulk group; elements past the map's extents are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// 2^x in one MUFU op (flushes results below 2^-126 to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// bar.sync on barrier 1 by the two consumer warpgroups only.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
}

// bar.sync on barrier 2 + wg by the 128 threads of warpgroup wg.
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// The byte offset of (row r, byte c) in a TMA box of RowBytes-byte rows
// written with the matching swizzle (128-byte rows: 16-byte chunk c / 16 at
// chunk (c / 16) ^ (r % 8); 64-byte rows: ^ (r / 2 % 4)); the box's base is
// aligned to 1024 bytes.
template <int RowBytes>
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  const uint32_t off = r * RowBytes + c;
  return off ^ (((off >> 7) & (RowBytes == 128 ? 7 : 3)) << 4);
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Commits the issued wgmmas as one group and waits for it.
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins registers that an asynchronous wgmma reads or writes to this point
// of the program, so the compiler neither reads them early nor reuses them.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets, swizzle (1: 128-byte, 2: 64-byte).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}

// d (+)= A B, m64 n64 k16: A and B from shared memory, both K-major;
// d is overwritten when scale_d is 0.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, "
      "%1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0; "
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, m64 n64 k16: A (bf16 pairs) from registers, B from shared
// memory, MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, "
      "%1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, "
      "1, 1; "
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, m64 n32 k16: A (bf16 pairs) from registers, B from shared
// memory, MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, "
      "%1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1; "
      "\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// bf16 route: wgmma
// ---------------------------------------------------------------------------

// (x, y) -> a bf16 pair, x in the low half (the lower k index of an A
// fragment).
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int Dp>
struct Bf16Tile {
  using G = Geom<__nv_bfloat16, Dp, 1>;
  static constexpr uint32_t kSwizzle = G::kRowBytes == 64 ? 2 : 1;
  static constexpr uint32_t kCore = 8 * G::kRowBytes;   // 8 rows of a box

  // Boxes loaded per row of a tile: all of them. Columns D .. Dp - 1 are
  // zero-filled by TMA and enter both products as zeros; no box lies wholly
  // past D (Dp - D < 64 for every served D).
  static __device__ __forceinline__ int boxes(int) { return G::kBoxes; }

  // s = Q K^T (unscaled) over the tile: Dp / 16 k16 steps. A k step moves
  // 32 bytes along a swizzled row, or to the next box every 64 columns.
  static __device__ __forceinline__ void scores(float* s, uint32_t sq,
                                                uint32_t sk, int, int, int) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Dp / 16; ++kk) {
      const uint32_t box = kk / 4, col = (kk % 4) * 32;
      wgmma_ss_n64(
          s, smem_desc(sq + box * G::kQBoxBytes + col, 16, kCore, kSwizzle),
          smem_desc(sk + box * G::kKvBoxBytes + col, 16, kCore, kSwizzle),
          kk > 0);
    }
    wgmma_commit_wait();
    fence_regs<32>(s);
  }

  // acc += P V: P (fp32, the score layout) rounded to bf16 A fragments, V
  // MN-major; a k16 step is 16 rows of V, 2 cores. Both byte offsets are
  // the 8-row core stride: along MN one box spans the instruction's N.
  static __device__ __forceinline__ void pv(float* acc, const float* p,
                                            uint32_t sv, int, int, int) {
    uint32_t pa[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
        pa[4 * kk + r] = pack_bf16(p[i], p[i + 1]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int b = 0; b < G::kBoxes; ++b) {
        const uint64_t dv = smem_desc(
            sv + b * G::kKvBoxBytes + kk * 2 * kCore, kCore, kCore, kSwizzle);
        if constexpr (Dp == 32)
          wgmma_rs_n32(acc, &pa[4 * kk], dv);
        else
          wgmma_rs_n64(acc + 32 * b, &pa[4 * kk], dv);
      }
    }
    wgmma_commit_wait();
    fence_regs<Dp / 2>(acc);
    fence_regs<16>(pa);
  }

  static __device__ __forceinline__ void store(__nv_bfloat16* out, float x,
                                               float y) {
    *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(x, y);
  }
};

// ---------------------------------------------------------------------------
// fp32 route: 3xTF32 mma.sync
// ---------------------------------------------------------------------------

// x = big + small with big = tf32(x), rounded to nearest, ties away (the
// rounding of cvt.rna.tf32.f32); small = x - big is exact. The tensor core
// reads small's top 19 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t* big,
                                           uint32_t* small) {
  const uint32_t b = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  *big = b;
  *small = __float_as_uint(x - __uint_as_float(b));
}

// c += a b, a: 16x8 tf32 (row), b: 8x8 tf32 (col), c: 16x8 fp32.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment split once into its big and small parts, for every B
// fragment it meets.
struct SplitA {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ SplitA split_a(float a0, float a1, float a2,
                                          float a3) {
  SplitA r;
  split_tf32(a0, &r.big[0], &r.small[0]);
  split_tf32(a1, &r.big[1], &r.small[1]);
  split_tf32(a2, &r.big[2], &r.small[2]);
  split_tf32(a3, &r.big[3], &r.small[3]);
  return r;
}

// c += a b in 3xTF32: the two cross products first, then big x big.
__device__ __forceinline__ void mma_3xtf32(float* c, const SplitA& a,
                                           float b0, float b1) {
  uint32_t bb[2], bs[2];
  split_tf32(b0, &bb[0], &bs[0]);
  split_tf32(b1, &bb[1], &bs[1]);
  mma_tf32(c, a.small, bb[0], bb[1]);
  mma_tf32(c, a.big, bs[0], bs[1]);
  mma_tf32(c, a.big, bb[0], bb[1]);
}

template <int Dp>
struct F32Tile {
  static constexpr int kKv = Cfg<float, Dp>::kKv;

  // Boxes of 32 columns loaded per row: those that hold a column below D.
  // The products run over the loaded boxes only (the columns of the last
  // past D are zero-filled), so a box never loaded is never read.
  static __device__ __forceinline__ int boxes(int d) { return (d + 31) / 32; }

  // Element (r, c) of one 128-byte swizzled box of 32 columns: the 16-byte
  // chunk c / 4 of row r sits at chunk (c / 4) ^ (r % 8).
  static __device__ __forceinline__ float at(const unsigned char* box, int r,
                                             int c) {
    return *reinterpret_cast<const float*>(
        box + r * 128 + (((c >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2));
  }

  static __device__ __forceinline__ const unsigned char* ptr(uint32_t a) {
    extern __shared__ unsigned char smem_raw[];
    return smem_raw + (a - smem_u32(smem_raw));
  }

  // s = Q K^T (unscaled): warp wq's 16 rows against the tile's kKv rows,
  // box by box; a k8 step reads Q and K columns 8 kk + c and 8 kk + c + 4
  // of the box.
  static __device__ __forceinline__ void scores(float* s, uint32_t sq,
                                                uint32_t sk, int wq,
                                                int lane, int d) {
    const int g = lane >> 2, c = lane & 3;
    const int r = 16 * wq + g;
#pragma unroll
    for (int i = 0; i < kKv / 2; ++i) s[i] = 0.0f;
    const int nb = boxes(d);
#pragma unroll
    for (int b = 0; b < Dp / 32; ++b) {
      if (b >= nb) break;
      const unsigned char* bq = ptr(sq) + b * (kTile * 128);
      const unsigned char* bk = ptr(sk) + b * (kKv * 128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int col = 8 * kk + c;
        const SplitA a = split_a(at(bq, r, col), at(bq, r + 8, col),
                                 at(bq, r, col + 4), at(bq, r + 8, col + 4));
#pragma unroll
        for (int nb8 = 0; nb8 < kKv / 8; ++nb8)
          mma_3xtf32(&s[4 * nb8], a, at(bk, 8 * nb8 + g, col),
                     at(bk, 8 * nb8 + g, col + 4));
      }
    }
  }

  // acc += P V over the loaded boxes of V: the k order of each 8-row block
  // of V is permuted so that k = c, c + 4 are kv rows 2c, 2c + 1, the
  // columns this thread holds of P; the A fragment is then P's own
  // registers.
  static __device__ __forceinline__ void pv(float* acc, const float* p,
                                            uint32_t sv, int, int lane,
                                            int d) {
    const int g = lane >> 2, c = lane & 3;
    const int nb = boxes(d);
    SplitA a[kKv / 8];
#pragma unroll
    for (int j = 0; j < kKv / 8; ++j)
      a[j] = split_a(p[4 * j], p[4 * j + 2], p[4 * j + 1], p[4 * j + 3]);
#pragma unroll
    for (int b = 0; b < Dp / 32; ++b) {
      if (b >= nb) break;
      const unsigned char* bv = ptr(sv) + b * (kKv * 128);
#pragma unroll
      for (int j = 0; j < kKv / 8; ++j) {
#pragma unroll
        for (int db = 0; db < 4; ++db)
          mma_3xtf32(&acc[4 * (4 * b + db)], a[j],
                     at(bv, 8 * j + 2 * c, 8 * db + g),
                     at(bv, 8 * j + 2 * c + 1, 8 * db + g));
      }
    }
  }

  static __device__ __forceinline__ void store(float* out, float x, float y) {
    *reinterpret_cast<float2*>(out) = make_float2(x, y);
  }
};

template <typename T, int Dp>
struct Route;
template <int Dp>
struct Route<__nv_bfloat16, Dp> : Bf16Tile<Dp> {};
template <int Dp>
struct Route<float, Dp> : F32Tile<Dp> {};

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// One thread's rows: row_a and row_a + 8 of warp wq's 16 rows of the 64
// that start at r0.
struct Rows {
  int r0, wq, lane, row_a, skv, causal;
  float scale2;   // D^-0.5 log2(e): scores in the log2 domain

  // The online-softmax step of kv tile t (KV rows) on the raw scores s, in
  // place (s -> p): the mask only where the tile crosses this warp's
  // diagonal or the end (masked scores at -inf, so p = 0 even in a row the
  // tile masks whole, as a 32-row kv tile can: the running max never
  // leaves its finite start of -1e30 there), the new running max, p =
  // 2^(s scale2 - m) in one FMA and one MUFU op, l. Returns in alpha the
  // factor that rescales the accumulator's rows.
  template <int KV>
  __device__ __forceinline__ void softmax(float* s, float* m_run,
                                          float* l_run, float* alpha,
                                          int t) const {
    const int kv0 = t * KV;
    const bool edge = kv0 + KV > skv ||
                      (causal && kv0 + KV - 1 > r0 + wq * 16);
    float m_cur[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < KV / 2; ++i) {
      if (edge) {
        const int col = kv0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int row = row_a + (((i >> 1) & 1) << 3);
        s[i] = col < skv && (!causal || col <= row) ? s[i] : -INFINITY;
      }
      m_cur[(i >> 1) & 1] = fmaxf(m_cur[(i >> 1) & 1], s[i]);
    }
    float neg_m[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_cur[h] = fmaxf(m_cur[h], __shfl_xor_sync(kFullMask, m_cur[h], 1));
      m_cur[h] = fmaxf(m_cur[h], __shfl_xor_sync(kFullMask, m_cur[h], 2));
      const float m_new = fmaxf(m_run[h], m_cur[h] * scale2);
      alpha[h] = ex2(m_run[h] - m_new);
      m_run[h] = m_new;
      neg_m[h] = -m_new;
    }
    float psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < KV / 2; ++i) {
      s[i] = ex2(__fmaf_rn(s[i], scale2, neg_m[(i >> 1) & 1]));
      psum[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = alpha[h] * l_run[h] + psum[h];
  }
};

template <int N>
__device__ __forceinline__ void rescale(float* acc, const float* alpha) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] *= alpha[(i >> 1) & 1];
}

// Dp: the padded width the kernel is built for; d: the true head dim (a
// multiple of 16, Dp - 64 < d <= Dp, or d <= Dp = 32), the tensor maps'
// innermost extent.
template <typename T, int Dp, int QT>
__global__ void __launch_bounds__(kThreads, Cfg<T, Dp>::kMinBlocks)
flash_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap to, int bh_count, int sq,
             int skv, int d, int causal, float scale) {
  using C = Cfg<T, Dp>;
  using G = Geom<T, Dp, QT>;
  using R = Route<T, Dp>;
  constexpr int S = G::kStages;
  constexpr int KV = C::kKv;
  // per stage: K landed, V landed, both read; and Q landed
  __shared__ __align__(8) uint64_t bars[3 * S + 1];
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // sQ; the stages follow

  // heaviest first: the last q tile of every head before any earlier one
  const int n_q = (sq + QT * kTile - 1) / (QT * kTile);
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x) / bh_count;
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int q0 = qt * QT * kTile;
  const int n_kv = (skv + KV - 1) / KV;
  // kv tiles of the CTA's last q row; the causal walk stops there
  const int n_tiles = causal ? min(n_kv, (q0 + QT * kTile - 1) / KV + 1)
                             : n_kv;

  const uint32_t kfull0 = smem_u32(&bars[0]);
  const uint32_t vfull0 = smem_u32(&bars[S]);
  const uint32_t empty0 = smem_u32(&bars[2 * S]);
  const uint32_t qbar = smem_u32(&bars[3 * S]);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(kfull0 + 8 * s, 1);
      mbar_init(vfull0 + 8 * s, 1);
      // every thread of the warpgroups that read the stage
      mbar_init(empty0 + 8 * s, QT * 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto k_tile = [&](int t) {
    return base + QT * G::kQTileBytes + 2 * G::kKvTileBytes * (t % S);
  };

  const int lane = threadIdx.x & 31;
  using Rg = Regs<C::kMinBlocks>;
  if (threadIdx.x >= kConsumers * 128) {   // the producer warpgroup
    setmaxnreg_dec<Rg::kProducer>();
    if (threadIdx.x == kConsumers * 128) {   // one thread starts every load
      const int nb = R::boxes(d);
      mbar_expect_tx(qbar, QT * nb * G::kQBoxBytes);
      for (int h = 0; h < QT; ++h)
        for (int b = 0; b < nb; ++b)
          tma_load(base + h * G::kQTileBytes + b * G::kQBoxBytes, &tq,
                   b * C::kBoxCols, q0 + h * kTile, bh, qbar);
      // K before V, each on its own barrier: Q K^T starts once K lands
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % S;
        mbar_wait(empty0 + 8 * st, ((t / S) & 1) ^ 1);
        mbar_expect_tx(kfull0 + 8 * st, nb * G::kKvBoxBytes);
        for (int b = 0; b < nb; ++b)
          tma_load(k_tile(t) + b * G::kKvBoxBytes, &tk, b * C::kBoxCols,
                   t * KV, bh, kfull0 + 8 * st);
        mbar_expect_tx(vfull0 + 8 * st, nb * G::kKvBoxBytes);
        for (int b = 0; b < nb; ++b)
          tma_load(k_tile(t) + G::kKvTileBytes + b * G::kKvBoxBytes, &tv,
                   b * C::kBoxCols, t * KV, bh, vfull0 + 8 * st);
      }
    }
    return;
  }
  setmaxnreg_inc<Rg::kConsumer>();

  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int wq = tid >> 5;   // this warp's 16 rows of the warpgroup's 64
  const int r0 = q0 + (QT == 2 ? wg * kTile : 0);   // the warpgroup's rows
  const Rows rows{r0, wq, lane, r0 + wq * 16 + (lane >> 2), skv, causal,
                  scale * kLog2e};
  // QT 1: alternate tiles of the CTA's walk; QT 2: every tile up to this
  // warpgroup's own last row (a skipped last tile is never waited on)
  const int first = QT == 1 ? wg : 0, step = QT == 1 ? kConsumers : 1;
  const int end = QT == 2 && causal ? min(n_tiles, (r0 + kTile - 1) / KV + 1)
                                    : n_tiles;
  const uint32_t sq_tile = base + (QT == 2 ? wg * G::kQTileBytes : 0);

  // s[4 j + e] and acc[4 j + e]: rows row_a + 8 (e >> 1), columns
  // 8 j + 2 (lane % 4) + (e & 1) of the score tile and of the output
  float s[KV / 2], acc[Dp / 2], alpha[2];
#pragma unroll
  for (int i = 0; i < KV / 2; ++i) s[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < Dp / 2; ++i) acc[i] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.0f, 0.0f};   // this thread's columns; quad-summed last

  mbar_wait(qbar, 0);
  for (int t = first; t < end; t += step) {
    const int st = t % S;
    mbar_wait(kfull0 + 8 * st, (t / S) & 1);
    R::scores(s, sq_tile, k_tile(t), wq, lane, d);
    rows.softmax<KV>(s, m_run, l_run, alpha, t);
    rescale<Dp / 2>(acc, alpha);
    mbar_wait(vfull0 + 8 * st, (t / S) & 1);
    R::pv(acc, s, k_tile(t) + G::kKvTileBytes, wq, lane, d);
    mbar_arrive(empty0 + 8 * st);
  }

  if constexpr (QT == 1) {
    // Merge: warpgroup 1's state through shared memory (the tiles are all
    // read), into warpgroup 0's, in this order.
    float* scratch = reinterpret_cast<float*>(smem_raw + (base - raw));
    consumers_sync();
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < Dp / 2; ++i) scratch[i * 128 + tid] = acc[i];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        scratch[(Dp / 2 + h) * 128 + tid] = m_run[h];
        scratch[(Dp / 2 + 2 + h) * 128 + tid] = l_run[h];
      }
    }
    consumers_sync();
    if (wg == 1) return;
    float f0[2], f1[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m1 = scratch[(Dp / 2 + h) * 128 + tid];
      const float m = fmaxf(m_run[h], m1);
      f0[h] = ex2(m_run[h] - m);
      f1[h] = ex2(m1 - m);
      l_run[h] =
          l_run[h] * f0[h] + scratch[(Dp / 2 + 2 + h) * 128 + tid] * f1[h];
    }
#pragma unroll
    for (int i = 0; i < Dp / 2; ++i) {
      const int h = (i >> 1) & 1;
      acc[i] = acc[i] * f0[h] + scratch[i * 128 + tid] * f1[h];
    }
  }
  // The output tile: normalised by one reciprocal of l a row, written in
  // the layout of a Q tile over this warpgroup's own (read) Q tile, then
  // stored by TMA box by box; rows past Sq and columns past D are not
  // written. Under QT 1 the merge's scratch lies there: every thread has
  // read it first.
  const int nb = R::boxes(d);
  if constexpr (QT == 1) warpgroup_sync(wg);
  unsigned char* so = smem_raw + (sq_tile - raw);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(kFullMask, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(kFullMask, l_run[h], 2);
    const float inv = 1.0f / fmaxf(l_run[h], kLFloor);
    const int r = wq * 16 + (lane >> 2) + 8 * h;   // of the warpgroup's 64
#pragma unroll
    for (int j = 0; j < Dp / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col / C::kBoxCols >= nb) break;
      R::store(reinterpret_cast<T*>(
                   so + (col / C::kBoxCols) * G::kQBoxBytes +
                   swizzled<G::kRowBytes>(r, (col % C::kBoxCols) * C::kEs)),
               acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  warpgroup_sync(wg);
  if (tid == 0) {
    for (int b = 0; b < nb; ++b)
      tma_store(&to, sq_tile + b * G::kQBoxBytes, b * C::kBoxCols, r0, bh);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (d, s, bh) tensor at ptr, boxes of kBoxCols columns x ``rows`` rows x
// 1 head; columns past d inside a box are zero-filled.
template <typename T, int Dp>
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int bh,
              int s, int d, int rows) {
  using C = Cfg<T, Dp>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * C::kEs,
                                 static_cast<cuuint64_t>(s) * d * C::kEs};
  const cuuint32_t box[3] = {C::kBoxCols, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map,
                C::kEs == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                3, const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                Geom<T, Dp, 1>::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int Dp, int QT>
int launch_grid(const CUtensorMap& tq, const CUtensorMap& tk,
                const CUtensorMap& tv, const CUtensorMap& to, int bh, int sq,
                int skv, int d, int causal, float scale, cudaStream_t stream) {
  const long long blocks =
      static_cast<long long>((sq + QT * kTile - 1) / (QT * kTile)) * bh;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = Geom<T, Dp, QT>::kSmem;
  const cudaError_t err =
      cudaFuncSetAttribute(flash_kernel<T, Dp, QT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_kernel<T, Dp, QT><<<static_cast<unsigned>(blocks), kThreads, bytes,
                            stream>>>(tq, tk, tv, to, bh, sq, skv, d, causal,
                                      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int Dp>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int skv, int d, int causal, float scale, int sms,
           cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv, to;
  constexpr int kv = Cfg<T, Dp>::kKv;
  if (!make_map<T, Dp>(encode, &tq, q, bh, sq, d, kTile) ||
      !make_map<T, Dp>(encode, &tk, k, bh, skv, d, kv) ||
      !make_map<T, Dp>(encode, &tv, v, bh, skv, d, kv) ||
      !make_map<T, Dp>(encode, &to, o, bh, sq, d, kTile))
    return static_cast<int>(cudaErrorInvalidValue);
  // bf16 at Dp >= 128 is bound by operations, and where its 64-row tiles
  // fill more than one wave (one CTA per SM) the kv tiles that every CTA
  // re-reads from L2 set the pace: 128-row q tiles read them half as often,
  // in half the CTAs. At Dp 192 and 256 that holds only without the causal
  // mask: with it, two waves of 64-row tiles, heaviest first, end sooner
  // than one of 128-row tiles whose heaviest walks every kv tile. Otherwise
  // the two warpgroups split one q tile's walk.
  const long long tiles = static_cast<long long>((sq + kTile - 1) / kTile) * bh;
  if constexpr (sizeof(T) == 2 && Dp >= 128) {
    if (tiles > sms && (Dp == 128 || !causal))
      return launch_grid<T, Dp, 2>(tq, tk, tv, to, bh, sq, skv, d, causal,
                                   scale, stream);
  }
  return launch_grid<T, Dp, 1>(tq, tk, tv, to, bh, sq, skv, d, causal, scale,
                               stream);
}

// d, a multiple of 16 up to 256, runs on the kernel of the least padded
// width Dp in {32, 64, 128, 192, 256} that holds it.
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh,
             int sq, int skv, int d, int causal, float scale, int sms,
             void* stream) {
  if (bh == 0 || sq == 0) return static_cast<int>(cudaGetLastError());
  if (d < 16 || d > 256 || d % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 32)
    return launch<T, 32>(q, k, v, o, bh, sq, skv, d, causal, scale, sms, s);
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, bh, sq, skv, d, causal, scale, sms, s);
  if (d <= 128)
    return launch<T, 128>(q, k, v, o, bh, sq, skv, d, causal, scale, sms, s);
  if (d <= 192)
    return launch<T, 192>(q, k, v, o, bh, sq, skv, d, causal, scale, sms, s);
  return launch<T, 256>(q, k, v, o, bh, sq, skv, d, causal, scale, sms, s);
}

}  // namespace

extern "C" {

// q, o: (bh, sq, d); k, v: (bh, skv, d); contiguous, 16-byte aligned, all
// bf16 (flash_fwd_bf16) or all fp32 (flash_fwd_f32); d a multiple of 16 up
// to 256; skv >= 1; scale = d^-0.5 as fp32; sms = the device's SM count.
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                   int bh, int sq, int skv, int d, int causal, float scale,
                   int sms, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, bh, sq, skv, d, causal, scale,
                                 sms, stream);
}

int flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                  int bh, int sq, int skv, int d, int causal, float scale,
                  int sms, void* stream) {
  return dispatch<float>(q, k, v, o, bh, sq, skv, d, causal, scale, sms,
                         stream);
}

}  // extern "C"
