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
//   (m, l, acc) in VMEM scratch; here one CTA owns a 64-row q tile and walks
//   its kv tiles itself.
//
// Bound on this card: bytes at D = 32 (the serve shape, BH 32, S 1024, bf16,
// causal: 8.4 MB of q, k, v and out, 2.5 us at 3.35 TB/s, against 2.15 GFLOP
// of the two products, 2.2 us at 989 TFLOP/s bf16), operations at D = 128
// (BH 16, S 4096, causal: 68.7 GFLOP, 69 us in bf16). What decides the time
// at D = 32 is neither: the exp of each score (one per 2 x 32 multiply-adds)
// and the chain of kv tiles that the last q tile of a causal head walks. At
// D = 128 with many q tiles, besides the tensor cores, the K and V tiles
// that every CTA reads again from L2 (1.09 GB at BH 16, S 4096, causal,
// with 64-row q tiles).
//
// One design for both routes. A CTA is one producer warp and two consumer
// warpgroups (288 threads) on one 64-row q tile, or on a 128-row one (below):
//   * The producer loads Q once, then K and V tile by tile (64 rows each)
//     with TMA into a ring of stages in shared memory, with a full and an
//     empty mbarrier per stage. The tensor maps are 3-D (D, S, BH), so TMA
//     zero-fills rows past Sq or Skv within a head; the mask is computed only
//     on tiles that cross a warp's diagonal or the end of Skv. Each box is
//     at most 128 bytes wide and written with the matching swizzle (64-byte
//     rows at bf16 D = 32, 128-byte rows otherwise; D = 128 bf16 is two
//     64-column boxes, fp32 is D / 32 boxes of 32 columns).
//   * The two consumer warpgroups split the kv walk: warpgroup w takes tiles
//     w, w + 2, ..., so the heaviest q tile's chain of tiles is halved. Each
//     keeps its own (m, l, acc); at the end warpgroup 1 hands its state to
//     warpgroup 0 through shared memory and warpgroup 0 merges the two in a
//     fixed order and writes the output: two launches on the same inputs
//     give the same bits.
//   * bf16 at D = 128, where the 64-row q tiles outnumber the SMs (more
//     than one wave at one CTA per SM), takes 128-row q tiles instead: each
//     warpgroup owns 64 rows and walks every kv tile up to its own last
//     row, and the two share each K and V stage, so the tiles are read from
//     L2 half as often; there is no merge.
//   * The grid is one CTA per (q tile, head), ordered heaviest first: the
//     largest q-tile index of every head is scheduled before any smaller
//     one, so where the grid is more than one wave the short causal tiles
//     fill the tail.
//   * Scores are scaled into the log2 domain (exp2). A warp owns 16 q rows;
//     a thread holds the same (row, column) pairs of the score tile and of
//     the output accumulator in both routes, so the softmax, the merge and
//     the epilogue are shared.
//
// The routes, chosen by the inputs' type:
//   bf16  wgmma. S = Q K^T is wgmma m64n64k16 with A = Q and B = the K tile,
//         both from shared memory, K-major as stored. P V is wgmma with A =
//         P from registers (the score accumulator's layout is the A
//         fragment's) and B = the V tile read MN-major through the
//         descriptor's transpose bit (m64n32k16 at D = 32, m64n64k16 per
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
//         fragment load feeds a 16 x 8 x 8 product. Fragments are read from
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

constexpr int kTile = 64;                    // rows of a q or kv tile
constexpr int kConsumers = 2;                // warpgroups on alternate kv tiles
constexpr int kThreads = kConsumers * 128 + 32;   // and one producer warp

// Per (element type, D): the TMA box width in columns (128 bytes at most,
// the widest swizzle), the ring's depth and the CTAs wanted per SM.
template <typename T, int D>
struct Cfg;

template <int D>
struct Cfg<__nv_bfloat16, D> {
  static constexpr int kEs = 2;
  static constexpr int kBoxCols = D < 64 ? D : 64;
  static constexpr int kStages = 4;
  static constexpr int kMinBlocks = D == 32 ? 2 : 1;
};

template <int D>
struct Cfg<float, D> {
  static constexpr int kEs = 4;
  static constexpr int kBoxCols = 32;
  static constexpr int kStages = D == 128 ? 3 : 4;
  static constexpr int kMinBlocks = 1;
};

// QT: 64-row q tiles per CTA (1: the warpgroups split the kv walk of one;
// 2: each warpgroup owns one and walks every kv tile).
template <typename T, int D, int QT>
struct Geom {
  using C = Cfg<T, D>;
  static constexpr int kRowBytes = C::kBoxCols * C::kEs;   // 64 or 128
  static constexpr int kBoxBytes = kTile * kRowBytes;
  static constexpr int kBoxes = D / C::kBoxCols;
  static constexpr int kTileBytes = kTile * D * C::kEs;
  // Q, then per stage a K tile and a V tile; 1024 bytes to align the base
  static constexpr int kSmem = 1024 + kTileBytes * (QT + 2 * C::kStages);
  // the merge's scratch (warpgroup 1's acc, m and l) reuses the tiles
  static_assert((D / 2 + 4) * 128 * 4 <= kTileBytes * (QT + 2 * C::kStages),
                "merge scratch does not fit");
  static_assert(kSmem <= 232448, "shared memory per block");
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

template <int D>
struct Bf16Tile {
  using G = Geom<__nv_bfloat16, D, 1>;
  static constexpr uint32_t kSwizzle = G::kRowBytes == 64 ? 2 : 1;
  static constexpr uint32_t kCore = 8 * G::kRowBytes;   // 8 rows of a box

  // s = Q K^T (unscaled) over the tile: D / 16 k16 steps. A k step moves
  // 32 bytes along a swizzled row, or to the next box at D = 128.
  static __device__ __forceinline__ void scores(float* s, uint32_t sq,
                                                uint32_t sk, int, int) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * G::kBoxBytes + (kk % 4) * 32;
      wgmma_ss_n64(s, smem_desc(sq + off, 16, kCore, kSwizzle),
                   smem_desc(sk + off, 16, kCore, kSwizzle), kk > 0);
    }
    wgmma_commit_wait();
    fence_regs<32>(s);
  }

  // acc += P V: P (fp32, the score layout) rounded to bf16 A fragments, V
  // MN-major; a k16 step is 16 rows of V, 2 cores. Both byte offsets are
  // the 8-row core stride: along MN one box spans the instruction's N.
  static __device__ __forceinline__ void pv(float* acc, const float* p,
                                            uint32_t sv, int, int) {
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
            sv + b * G::kBoxBytes + kk * 2 * kCore, kCore, kCore, kSwizzle);
        if constexpr (D == 32)
          wgmma_rs_n32(acc, &pa[4 * kk], dv);
        else
          wgmma_rs_n64(acc + 32 * b, &pa[4 * kk], dv);
      }
    }
    wgmma_commit_wait();
    fence_regs<D / 2>(acc);
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

// c += a b in 3xTF32: the two cross products first, then big x big.
__device__ __forceinline__ void mma_3xtf32(float* c, const float* a,
                                           float b0, float b1) {
  uint32_t ab[4], as[4], bb[2], bs[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], &ab[i], &as[i]);
  split_tf32(b0, &bb[0], &bs[0]);
  split_tf32(b1, &bb[1], &bs[1]);
  mma_tf32(c, as, bb[0], bb[1]);
  mma_tf32(c, ab, bs[0], bs[1]);
  mma_tf32(c, ab, bb[0], bb[1]);
}

template <int D>
struct F32Tile {
  // Element (r, c) of a TMA tile of 128-byte swizzled boxes of 32 columns:
  // the 16-byte chunk (c % 32) / 4 of row r sits at chunk ((c % 32) / 4) ^
  // (r % 8).
  static __device__ __forceinline__ float at(const unsigned char* tile, int r,
                                             int c) {
    return *reinterpret_cast<const float*>(
        tile + (c >> 5) * (kTile * 128) + r * 128 +
        ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2));
  }

  static __device__ __forceinline__ const unsigned char* ptr(uint32_t a) {
    extern __shared__ unsigned char smem_raw[];
    return smem_raw + (a - smem_u32(smem_raw));
  }

  // s = Q K^T (unscaled): warp wq's 16 rows against the tile's 64 rows; a
  // k8 step reads Q and K columns 8 kk + c and 8 kk + c + 4.
  static __device__ __forceinline__ void scores(float* s, uint32_t sq,
                                                uint32_t sk, int wq,
                                                int lane) {
    const unsigned char* tq = ptr(sq);
    const unsigned char* tk = ptr(sk);
    const int g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
#pragma unroll 2
    for (int kk = 0; kk < D / 8; ++kk) {
      const int col = 8 * kk + c;
      const int r = 16 * wq + g;
      const float a[4] = {at(tq, r, col), at(tq, r + 8, col),
                          at(tq, r, col + 4), at(tq, r + 8, col + 4)};
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        mma_3xtf32(&s[4 * nb], a, at(tk, 8 * nb + g, col),
                   at(tk, 8 * nb + g, col + 4));
    }
  }

  // acc += P V: the k order of each 8-row block of V is permuted so that
  // k = c, c + 4 are kv rows 2c, 2c + 1, the columns this thread holds of
  // P; the A fragment is then P's own registers.
  static __device__ __forceinline__ void pv(float* acc, const float* p,
                                            uint32_t sv, int, int lane) {
    const unsigned char* tv = ptr(sv);
    const int g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float a[4] = {p[4 * j], p[4 * j + 2], p[4 * j + 1], p[4 * j + 3]};
#pragma unroll
      for (int db = 0; db < D / 8; ++db)
        mma_3xtf32(&acc[4 * db], a, at(tv, 8 * j + 2 * c, 8 * db + g),
                   at(tv, 8 * j + 2 * c + 1, 8 * db + g));
    }
  }

  static __device__ __forceinline__ void store(float* out, float x, float y) {
    *reinterpret_cast<float2*>(out) = make_float2(x, y);
  }
};

template <typename T, int D>
struct Route;
template <int D>
struct Route<__nv_bfloat16, D> : Bf16Tile<D> {};
template <int D>
struct Route<float, D> : F32Tile<D> {};

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// One thread's rows: row_a and row_a + 8 of warp wq's 16 rows of the 64
// that start at r0.
struct Rows {
  int r0, wq, lane, row_a, skv, causal;
  float scale2;   // D^-0.5 log2(e): scores in the log2 domain

  // The online-softmax step of kv tile t on the raw scores s, in place (s
  // -> p): the mask only where the tile crosses this warp's diagonal or
  // the end (masked scores at -1e30), the new running max, p = 2^(s scale2
  // - m) in one FMA and one MUFU op, l. Returns in alpha the factor that
  // rescales the accumulator's rows.
  __device__ __forceinline__ void softmax(float* s, float* m_run,
                                          float* l_run, float* alpha,
                                          int t) const {
    const int kv0 = t * kTile;
    const bool edge = kv0 + kTile > skv ||
                      (causal && kv0 + kTile - 1 > r0 + wq * 16);
    float m_cur[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (edge) {
        const int col = kv0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int row = row_a + (((i >> 1) & 1) << 3);
        s[i] = col < skv && (!causal || col <= row) ? s[i] : kNegInf;
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
    for (int i = 0; i < 32; ++i) {
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

template <typename T, int D, int QT>
__global__ void __launch_bounds__(kThreads, Cfg<T, D>::kMinBlocks)
flash_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, T* __restrict__ o,
             int bh_count, int sq, int skv, int causal, float scale) {
  using C = Cfg<T, D>;
  using G = Geom<T, D, QT>;
  using R = Route<T, D>;
  constexpr int S = C::kStages;
  __shared__ __align__(8) uint64_t bars[2 * S + 1];   // full, empty, Q
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;   // sQ; the stages follow

  // heaviest first: the last q tile of every head before any earlier one
  const int n_q = (sq + QT * kTile - 1) / (QT * kTile);
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x) / bh_count;
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int q0 = qt * QT * kTile;
  const int n_kv = (skv + kTile - 1) / kTile;
  // kv tiles of the CTA's last q row; the causal walk stops there
  const int n_tiles = causal ? min(n_kv, (q0 + QT * kTile - 1) / kTile + 1)
                             : n_kv;

  const uint32_t full0 = smem_u32(&bars[0]);
  const uint32_t empty0 = smem_u32(&bars[S]);
  const uint32_t qbar = smem_u32(&bars[2 * S]);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      // every thread of the warpgroups that read the stage
      mbar_init(empty0 + 8 * s, QT * 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto k_tile = [&](int t) {
    return base + G::kTileBytes * (QT + 2 * (t % S));
  };

  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= kConsumers * 128) {   // the producer warp
    if (lane == 0) {
      mbar_expect_tx(qbar, QT * G::kTileBytes);
#pragma unroll
      for (int h = 0; h < QT; ++h)
#pragma unroll
        for (int b = 0; b < G::kBoxes; ++b)
          tma_load(base + h * G::kTileBytes + b * G::kBoxBytes, &tq,
                   b * C::kBoxCols, q0 + h * kTile, bh, qbar);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % S;
        mbar_wait(empty0 + 8 * st, ((t / S) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * st, 2 * G::kTileBytes);
#pragma unroll
        for (int b = 0; b < G::kBoxes; ++b) {
          tma_load(k_tile(t) + b * G::kBoxBytes, &tk, b * C::kBoxCols,
                   t * kTile, bh, full0 + 8 * st);
          tma_load(k_tile(t) + G::kTileBytes + b * G::kBoxBytes, &tv,
                   b * C::kBoxCols, t * kTile, bh, full0 + 8 * st);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int wq = tid >> 5;   // this warp's 16 rows of the warpgroup's 64
  const int r0 = q0 + (QT == 2 ? wg * kTile : 0);   // the warpgroup's rows
  const Rows rows{r0, wq, lane, r0 + wq * 16 + (lane >> 2), skv, causal,
                  scale * kLog2e};
  // QT 1: alternate tiles of the CTA's walk; QT 2: every tile up to this
  // warpgroup's own last row (a skipped last tile is never waited on)
  const int first = QT == 1 ? wg : 0, step = QT == 1 ? kConsumers : 1;
  const int end = QT == 2 && causal ? min(n_tiles, (r0 + kTile - 1) / kTile + 1)
                                    : n_tiles;
  const uint32_t sq_tile = base + (QT == 2 ? wg * G::kTileBytes : 0);

  // s[4 j + e] and acc[4 j + e]: rows row_a + 8 (e >> 1), columns
  // 8 j + 2 (lane % 4) + (e & 1) of the score tile and of the output
  float s[32], acc[D / 2], alpha[2];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.0f, 0.0f};   // this thread's columns; quad-summed last

  mbar_wait(qbar, 0);
  for (int t = first; t < end; t += step) {
    mbar_wait(full0 + 8 * (t % S), (t / S) & 1);
    R::scores(s, sq_tile, k_tile(t), wq, lane);
    rows.softmax(s, m_run, l_run, alpha, t);
    rescale<D / 2>(acc, alpha);
    R::pv(acc, s, k_tile(t) + G::kTileBytes, wq, lane);
    mbar_arrive(empty0 + 8 * (t % S));
  }

  if constexpr (QT == 1) {
    // Merge: warpgroup 1's state through shared memory (the tiles are all
    // read), into warpgroup 0's, in this order.
    float* scratch = reinterpret_cast<float*>(smem_raw + (base - raw));
    consumers_sync();
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) scratch[i * 128 + tid] = acc[i];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        scratch[(D / 2 + h) * 128 + tid] = m_run[h];
        scratch[(D / 2 + 2 + h) * 128 + tid] = l_run[h];
      }
    }
    consumers_sync();
    if (wg == 1) return;
    float f0[2], f1[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m1 = scratch[(D / 2 + h) * 128 + tid];
      const float m = fmaxf(m_run[h], m1);
      f0[h] = ex2(m_run[h] - m);
      f1[h] = ex2(m1 - m);
      l_run[h] =
          l_run[h] * f0[h] + scratch[(D / 2 + 2 + h) * 128 + tid] * f1[h];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      const int h = (i >> 1) & 1;
      acc[i] = acc[i] * f0[h] + scratch[i * 128 + tid] * f1[h];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(kFullMask, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(kFullMask, l_run[h], 2);
    l_run[h] = fmaxf(l_run[h], kLFloor);
    const int row = rows.row_a + 8 * h;
    if (row >= sq) continue;
    T* out = o + (static_cast<size_t>(bh) * sq + row) * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      R::store(out + 8 * j, acc[4 * j + 2 * h] / l_run[h],
               acc[4 * j + 2 * h + 1] / l_run[h]);
  }
}

// ---------------------------------------------------------------------------
// The mma route: D a multiple of 16 up to 256, outside {32, 64, 128}
// ---------------------------------------------------------------------------
//
// A CTA of four warps owns a 64-row q tile and walks its kv tiles (64 rows)
// with one (m, l, acc) per row, as Rows::softmax keeps it: warp w owns rows
// 16 w .. 16 w + 15, and a thread holds the same (row, column) pairs of the
// score tile and of the output as in the wgmma route. Q, then each K and V
// tile, are copied into shared memory with 16-byte loads by all 128 threads
// (rows past Sq or Skv zero-filled), between two __syncthreads; no TMA, no
// ring: a simple kernel first. Rows are padded by 16 bytes so the fragment
// loads below hit 32 distinct banks.
//   bf16  tensor cores through mma.sync m16n8k16 (HMMA): S = Q K^T with A =
//         Q and B = K read as 32-bit pairs along D; P V with A = P from the
//         score registers rounded to bf16 (as in the wgmma route and SDPA)
//         and B = V, which is stored transposed (D rows of 64 kv) so that its
//         pairs along kv are 32-bit loads too.
//   fp32  SIMT FMA in fp32: each thread forms its 32 scores as dot products
//         over D from float4 rows of Q and K, and P V takes each kv column's
//         p from the quad's owner by a shuffle.

// c += a b, a: 16x16 bf16 (row), b: 16x8 bf16 (col), c: 16x8 fp32.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T, int D>
struct Mma;

template <int D>
struct Mma<__nv_bfloat16, D> {
  using T = __nv_bfloat16;
  static constexpr int kLd = D + 8;          // Q and K rows, in elements
  static constexpr int kLdV = kTile + 8;     // V^T rows (one per d)
  static constexpr int kSmem = (2 * kTile * kLd + D * kLdV) * 2;

  static __device__ __forceinline__ uint32_t pair(const T* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }

  static __device__ __forceinline__ void store_v(T* sv, int r, int c,
                                                 const uint4& val) {
    const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) sv[(c + j) * kLdV + r] = e[j];
  }

  // s = Q K^T (unscaled) of warp wq's 16 rows against the tile's 64.
  static __device__ __forceinline__ void scores(float* s, const T* sq,
                                                const T* sk, int wq,
                                                int lane) {
    const int g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    const T* qa = sq + (16 * wq + g) * kLd + 2 * c;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a[4] = {pair(qa + 16 * kk), pair(qa + 8 * kLd + 16 * kk),
                             pair(qa + 16 * kk + 8),
                             pair(qa + 8 * kLd + 16 * kk + 8)};
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const T* kb = sk + (8 * nb + g) * kLd + 16 * kk + 2 * c;
        mma_bf16(&s[4 * nb], a, pair(kb), pair(kb + 8));
      }
    }
  }

  // acc += P V: a k16 step is score blocks 2 kk and 2 kk + 1 (kv 16 kk ..
  // 16 kk + 15), whose accumulator registers are the A fragment's order.
  static __device__ __forceinline__ void pv(float* acc, const float* p,
                                            const T* sv, int lane) {
    const int g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* pk = p + 8 * kk;
      const uint32_t a[4] = {pack_bf16(pk[0], pk[1]), pack_bf16(pk[2], pk[3]),
                             pack_bf16(pk[4], pk[5]), pack_bf16(pk[6], pk[7])};
#pragma unroll
      for (int db = 0; db < D / 8; ++db) {
        const T* vb = sv + (8 * db + g) * kLdV + 16 * kk + 2 * c;
        mma_bf16(&acc[4 * db], a, pair(vb), pair(vb + 8));
      }
    }
  }

  static __device__ __forceinline__ void store(T* out, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(x, y);
  }
};

template <int D>
struct Mma<float, D> {
  using T = float;
  static constexpr int kLd = D + 4;          // Q, K and V rows
  static constexpr int kSmem = 3 * kTile * kLd * 4;

  static __device__ __forceinline__ void store_v(T* sv, int r, int c,
                                                 const uint4& val) {
    *reinterpret_cast<uint4*>(sv + r * kLd + c) = val;
  }

  // s = Q K^T (unscaled): s[4 j + 2 h + e] = row 16 wq + g + 8 h against kv
  // row 8 j + 2 c + e, summed over D in fp32.
  static __device__ __forceinline__ void scores(float* s, const T* sq,
                                                const T* sk, int wq,
                                                int lane) {
    const int g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    const T* q0 = sq + (16 * wq + g) * kLd;
#pragma unroll 2
    for (int k4 = 0; k4 < D; k4 += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(q0 + k4);
      const float4 a1 = *reinterpret_cast<const float4*>(q0 + 8 * kLd + k4);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int j = i >> 1, e = i & 1;
        const float4 b = *reinterpret_cast<const float4*>(
            sk + (8 * j + 2 * c + e) * kLd + k4);
        float* lo = &s[4 * j + e];
        float* hi = &s[4 * j + 2 + e];
        *lo = __fmaf_rn(a0.x, b.x, *lo);
        *lo = __fmaf_rn(a0.y, b.y, *lo);
        *lo = __fmaf_rn(a0.z, b.z, *lo);
        *lo = __fmaf_rn(a0.w, b.w, *lo);
        *hi = __fmaf_rn(a1.x, b.x, *hi);
        *hi = __fmaf_rn(a1.y, b.y, *hi);
        *hi = __fmaf_rn(a1.z, b.z, *hi);
        *hi = __fmaf_rn(a1.w, b.w, *hi);
      }
    }
  }

  // acc += P V: kv column 8 j + 2 cc + e of rows g and g + 8 is held by the
  // quad's lane cc; it is shuffled to the quad and multiplies V's row.
  static __device__ __forceinline__ void pv(float* acc, const float* p,
                                            const T* sv, int lane) {
    const int c = lane & 3, quad = lane & ~3;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p0 = __shfl_sync(kFullMask, p[4 * j + e], quad | cc);
          const float p1 = __shfl_sync(kFullMask, p[4 * j + 2 + e], quad | cc);
          const T* vr = sv + (8 * j + 2 * cc + e) * kLd + 2 * c;
#pragma unroll
          for (int db = 0; db < D / 8; ++db) {
            const float2 v = *reinterpret_cast<const float2*>(vr + 8 * db);
            float* a = &acc[4 * db];
            a[0] = __fmaf_rn(p0, v.x, a[0]);
            a[1] = __fmaf_rn(p0, v.y, a[1]);
            a[2] = __fmaf_rn(p1, v.x, a[2]);
            a[3] = __fmaf_rn(p1, v.y, a[3]);
          }
        }
      }
    }
  }

  static __device__ __forceinline__ void store(float* out, float x, float y) {
    *reinterpret_cast<float2*>(out) = make_float2(x, y);
  }
};

// Rows row0 .. row0 + 63 of a (n, D) matrix into shared memory (row stride
// ld elements) with 16-byte loads, rows at or past n zero; each 16 bytes
// handed to ``put(r, c, val)``.
template <typename T, int D, typename Put>
__device__ __forceinline__ void load_tile(const T* src, int row0, int n,
                                          Put put) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += 128) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * D + c);
    put(r, c, val);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(128, 1)
flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int bh_count,
                 int sq, int skv, int causal, float scale) {
  using M = Mma<T, D>;
  extern __shared__ unsigned char smem_raw[];   // 16-byte aligned: no
                                                // static shared memory
  T* s_q = reinterpret_cast<T*>(smem_raw);
  T* s_k = s_q + kTile * M::kLd;
  T* s_v = s_k + kTile * M::kLd;

  // heaviest first, as flash_kernel
  const int n_q = (sq + kTile - 1) / kTile;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x) / bh_count) * kTile;
  const size_t bh = static_cast<size_t>(blockIdx.x) % bh_count;
  const int n_kv = (skv + kTile - 1) / kTile;
  const int n_tiles = causal ? min(n_kv, (q0 + kTile - 1) / kTile + 1) : n_kv;
  const T* kb = k + bh * skv * D;
  const T* vb = v + bh * skv * D;

  const auto put_row = [](T* dst) {
    return [dst](int r, int c, const uint4& val) {
      *reinterpret_cast<uint4*>(dst + r * M::kLd + c) = val;
    };
  };
  load_tile<T, D>(q + bh * sq * D, q0, sq, put_row(s_q));

  const int lane = threadIdx.x & 31, wq = threadIdx.x >> 5;
  const Rows rows{q0, wq, lane, q0 + wq * 16 + (lane >> 2), skv, causal,
                  scale * kLog2e};
  float s[32], acc[D / 2], alpha[2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.0f, 0.0f};   // this thread's columns; quad-summed last

  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();   // the previous tile is read
    load_tile<T, D>(kb, t * kTile, skv, put_row(s_k));
    load_tile<T, D>(vb, t * kTile, skv,
                    [s_v](int r, int c, const uint4& val) {
                      M::store_v(s_v, r, c, val);
                    });
    __syncthreads();
    M::scores(s, s_q, s_k, wq, lane);
    rows.softmax(s, m_run, l_run, alpha, t);
    rescale<D / 2>(acc, alpha);
    M::pv(acc, s, s_v, lane);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(kFullMask, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(kFullMask, l_run[h], 2);
    l_run[h] = fmaxf(l_run[h], kLFloor);
    const int row = rows.row_a + 8 * h;
    if (row >= sq) continue;
    T* out = o + (bh * sq + row) * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      M::store(out + 8 * j, acc[4 * j + 2 * h] / l_run[h],
               acc[4 * j + 2 * h + 1] / l_run[h]);
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

// The (D, s, bh) tensor at ptr, boxes of kBoxCols x 64 rows x 1 head.
template <typename T, int D>
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int bh,
              int s) {
  using C = Cfg<T, D>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * C::kEs,
                                 static_cast<cuuint64_t>(s) * D * C::kEs};
  const cuuint32_t box[3] = {C::kBoxCols, kTile, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map,
                C::kEs == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                3, const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                Geom<T, D, 1>::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D, int QT>
int launch_grid(const CUtensorMap& tq, const CUtensorMap& tk,
                const CUtensorMap& tv, void* o, int bh, int sq, int skv,
                int causal, float scale, cudaStream_t stream) {
  const long long blocks =
      static_cast<long long>((sq + QT * kTile - 1) / (QT * kTile)) * bh;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = Geom<T, D, QT>::kSmem;
  const cudaError_t err =
      cudaFuncSetAttribute(flash_kernel<T, D, QT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_kernel<T, D, QT><<<static_cast<unsigned>(blocks), kThreads, bytes,
                           stream>>>(tq, tk, tv, static_cast<T*>(o), bh, sq,
                                     skv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int skv, int causal, float scale, int sms,
           cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv;
  if (!make_map<T, D>(encode, &tq, q, bh, sq) ||
      !make_map<T, D>(encode, &tk, k, bh, skv) ||
      !make_map<T, D>(encode, &tv, v, bh, skv))
    return static_cast<int>(cudaErrorInvalidValue);
  // bf16 at D = 128 is bound by operations, and where its 64-row tiles
  // fill more than one wave (one CTA per SM) the kv tiles that every CTA
  // re-reads from L2 set the pace: 128-row q tiles read them half as often.
  // Otherwise the two warpgroups split one q tile's walk.
  const long long tiles = static_cast<long long>((sq + kTile - 1) / kTile) * bh;
  if constexpr (sizeof(T) == 2 && D == 128) {
    if (tiles > sms)
      return launch_grid<T, D, 2>(tq, tk, tv, o, bh, sq, skv, causal, scale,
                                  stream);
  }
  return launch_grid<T, D, 1>(tq, tk, tv, o, bh, sq, skv, causal, scale,
                              stream);
}

template <typename T, int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int bh,
               int sq, int skv, int causal, float scale, cudaStream_t stream) {
  const long long blocks =
      static_cast<long long>((sq + kTile - 1) / kTile) * bh;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = Mma<T, D>::kSmem;
  static_assert(bytes <= 232448, "shared memory per block");
  const cudaError_t err =
      cudaFuncSetAttribute(flash_mma_kernel<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_mma_kernel<T, D><<<static_cast<unsigned>(blocks), 128, bytes,
                           stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), bh, sq, skv, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh,
             int sq, int skv, int d, int causal, float scale, int sms,
             void* stream) {
  if (bh == 0 || sq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_MMA(D)                                                      \
  case D:                                                                 \
    return launch_mma<T, D>(q, k, v, o, bh, sq, skv, causal, scale, s);
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, bh, sq, skv, causal, scale, sms, s);
    case 64:
      return launch<T, 64>(q, k, v, o, bh, sq, skv, causal, scale, sms, s);
    case 128:
      return launch<T, 128>(q, k, v, o, bh, sq, skv, causal, scale, sms, s);
    FLASH_MMA(16) FLASH_MMA(48) FLASH_MMA(80) FLASH_MMA(96) FLASH_MMA(112)
    FLASH_MMA(144) FLASH_MMA(160) FLASH_MMA(176) FLASH_MMA(192)
    FLASH_MMA(208) FLASH_MMA(224) FLASH_MMA(240) FLASH_MMA(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_MMA
}

}  // namespace

extern "C" {

// q, o: (bh, sq, d); k, v: (bh, skv, d); contiguous, 16-byte aligned, all
// bf16 (flash_fwd_bf16) or all fp32 (flash_fwd_f32); d in {32, 64, 128}
// (the wgmma + TMA route) or another multiple of 16 up to 256 (mma.sync);
// skv >= 1; scale = d^-0.5 as fp32; sms = the device's SM count.
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
