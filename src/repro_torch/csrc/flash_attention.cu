// Hopper (sm_90a) attention forward of prefill: softmax(q k^T * D^-0.5) v
// over (BH, S, D) tensors, with the online softmax of flash attention.
//
// flash_attention_fwd  replaces src/repro/kernels/flash_attention.py:
//                       flash_attention_fwd (Pallas _flash_fwd_kernel). Per
//                       q tile the kernel keeps the running max m (from
//                       -1e30), the running sum l (from 0) and an fp32
//                       accumulator across the kv tiles, rescales them by
//                       alpha = exp(m_prev - m_new) at each tile, and
//                       finishes with acc / max(l, 1e-30), as the Pallas
//                       body does. The causal mask is kv_idx <= q_idx on
//                       absolute indices, with no offset when Sq != Skv (the
//                       reference's rule). kv tiles that lie wholly above the
//                       diagonal are skipped: every row has kv 0 valid, so
//                       such a tile would add p = 0 at alpha = 1.
//   The TPU kernel walks the kv grid axis in order on one core and carries
//   (m, l, acc) in VMEM scratch; here one CTA owns a q tile and loops over
//   the kv tiles itself, with K and V staged in shared memory.
//
// Two routes, chosen by the inputs' type:
//   bf16  tensor cores: mma.sync.m16n8k16 bf16 x bf16 -> fp32. A CTA of 4
//         warps owns 64 q rows (16 per warp, Q held in registers as mma A
//         fragments, loaded once with ldmatrix); each kv tile of 64 rows is
//         staged in shared memory with cp.async, two buffers deep, so tile
//         t + 1 loads while tile t is used (rows padded by 16 bytes, so
//         ldmatrix is free of bank conflicts). S = Q K^T comes from
//         ldmatrix'd K fragments; P V from ldmatrix.trans'd V fragments.
//         Scores are scaled into the log2 domain (exp2), and the mask is
//         computed only on tiles that cross a warp's diagonal or the end.
//         P stays fp32 in the softmax and in l; for the P V product each p
//         is split into bf16 hi + lo (hi = bf16(p), lo = bf16(p - hi)) and
//         both halves go through the tensor cores, so P enters the product
//         with 16 significant bits rather than bf16's 8.
//   fp32  SIMT, fp32 FMA (TF32 mma keeps 10 bits and cannot hold the
//         reference's 2e-5): a CTA of 128 threads owns 32 q rows, 4 threads
//         a row, each thread holding D/4 interleaved dims (d = g + 4 i) of q
//         and of the accumulator; a score is the 4 threads' partial dot
//         products added with two shuffles. kv tiles of 32 rows.
//
// Bound: at the serve shape (BH 32 = 4 x 8 heads, S 1024, D 32, bf16,
// causal) 8.4 MB of q, k, v and out, 2.5 us at 3.35 TB/s, and 2.15 GFLOP of
// the two products over the S (S + 1) / 2 unmasked scores, 2.2 us at 989
// TFLOP/s bf16. At D 32 the exp of each score, not the products, takes
// most of the time (one exp per 2 x 32 multiply-adds).
//
// The source is built with --fmad=false like the others; the dot products
// call fmaf explicitly, so the fp32 route still multiplies and adds in one
// rounding.
//
// C interface for ctypes; every entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLFloor = 1e-30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFullMask = 0xffffffffu;

// ---------------------------------------------------------------------------
// bf16 route
// ---------------------------------------------------------------------------

constexpr int kBr = 64;            // q rows per CTA, 16 per warp
constexpr int kBc = 64;            // kv rows per tile
constexpr int kThreadsB = 128;     // 4 warps

// Shared-memory row stride of a (rows, D) bf16 tile, in elements.
template <int D>
__host__ __device__ constexpr int row_stride() { return D + 8; }

// Q, and two buffers each of K and V: tile t + 1 loads while tile t is used.
template <int D>
__host__ __device__ constexpr int smem_bytes_bf16() {
  return (kBr + 4 * kBc) * row_stride<D>() * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared; zero-fills when !valid (src not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b, a: 16x16 bf16 (row), b: 16x8 bf16 (col), c: 16x8 fp32.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) -> bf16 pairs hi = bf16(x, y) and lo = bf16(x - hi.x, y - hi.y);
// x goes to the low half (the lower column of an mma fragment).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t* hi,
                                           uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  *hi = as_u32(h);
  *lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// Loads rows [row0, row0 + rows) of a (n_rows, D) bf16 matrix into a
// shared tile of stride row_stride<D>(), zero-filling rows past n_rows.
template <int D, int kRows>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int n_rows) {
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreadsB) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + r * row_stride<D>() + col,
               src + static_cast<size_t>(ok ? row0 + r : 0) * D + col, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsB)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int sq, int skv, int causal,
                  float scale) {
  constexpr int S = row_stride<D>();
  constexpr int kSteps = D / 16;   // k16 steps of Q K^T
  constexpr int kDBlocks = D / 8;  // n8 blocks of the output
  constexpr int kNBlocks = kBc / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kBr * S;        // two buffers of kBc rows
  __nv_bfloat16* sV = sK + 2 * kBc * S;    // two buffers of kBc rows

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBr;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t base_q = static_cast<size_t>(bh) * sq * D;
  const size_t base_kv = static_cast<size_t>(bh) * skv * D;

  // Q and the first K, V tile in one group
  load_tile<D, kBr>(sQ, q + base_q, q0, sq);
  load_tile<D, kBc>(sK, k + base_kv, 0, skv);
  load_tile<D, kBc>(sV, v + base_kv, 0, skv);
  cp_async_commit();
  uint32_t qf[kSteps][4];
  const float scale2 = scale * kLog2e;   // scores in the log2 domain

  float acc[kDBlocks][4];
#pragma unroll
  for (int db = 0; db < kDBlocks; ++db)
    acc[db][0] = acc[db][1] = acc[db][2] = acc[db][3] = 0.0f;
  // this thread's two rows: fragment entries 0, 1 and 2, 3
  const int row_a = q0 + warp * 16 + (lane >> 2);
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.0f, 0.0f};   // this thread's columns; quad-summed last

  int n_tiles = (skv + kBc - 1) / kBc;
  if (causal) n_tiles = min(n_tiles, (q0 + kBr - 1) / kBc + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBc;
    const __nv_bfloat16* tK = sK + (t & 1) * kBc * S;
    const __nv_bfloat16* tV = sV + (t & 1) * kBc * S;
    if (t + 1 < n_tiles) {   // the next tile into the other buffer
      load_tile<D, kBc>(sK + ((t + 1) & 1) * kBc * S, k + base_kv, kv0 + kBc,
                        skv);
      load_tile<D, kBc>(sV + ((t + 1) & 1) * kBc * S, v + base_kv, kv0 + kBc,
                        skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk)
        ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * S + kk * 16 +
                                ((lane >> 4) << 3));
    }

    float s[kNBlocks][4];
#pragma unroll
    for (int nb = 0; nb < kNBlocks; ++nb)
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int nb2 = 0; nb2 < kNBlocks / 2; ++nb2) {
        const int mi = lane >> 3;
        uint32_t b[4];
        ldmatrix_x4(b, tK + (nb2 * 16 + (lane & 7) + ((mi >> 1) << 3)) * S +
                           kk * 16 + ((mi & 1) << 3));
        mma_bf16(s[2 * nb2], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * nb2 + 1], qf[kk], b[2], b[3]);
      }
    }

    // the mask only where the tile crosses this warp's diagonal or the end
    const bool edge = kv0 + kBc > skv ||
                      (causal && kv0 + kBc - 1 > q0 + warp * 16);
    float m_cur[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < kNBlocks; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * scale2;
        if (edge) {
          const int col = kv0 + nb * 8 + 2 * (lane & 3) + (e & 1);
          const int row = row_a + ((e >> 1) << 3);
          x = col < skv && (!causal || col <= row) ? x : kNegInf;
        }
        s[nb][e] = x;
        m_cur[e >> 1] = fmaxf(m_cur[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_cur[i] = fmaxf(m_cur[i], __shfl_xor_sync(kFullMask, m_cur[i], 1));
      m_cur[i] = fmaxf(m_cur[i], __shfl_xor_sync(kFullMask, m_cur[i], 2));
      const float m_new = fmaxf(m_run[i], m_cur[i]);
      alpha[i] = exp2f(m_run[i] - m_new);
      m_run[i] = m_new;
    }
    float psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nb = 0; nb < kNBlocks; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = exp2f(s[nb][e] - m_run[e >> 1]);
        psum[e >> 1] += s[nb][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = alpha[i] * l_run[i] + psum[i];
#pragma unroll
    for (int db = 0; db < kDBlocks; ++db) {
      acc[db][0] *= alpha[0];
      acc[db][1] *= alpha[0];
      acc[db][2] *= alpha[1];
      acc[db][3] *= alpha[1];
    }

    // acc += P V: P's C fragments are the A fragments of the product
#pragma unroll
    for (int kk = 0; kk < kBc / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], &hi[0], &lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], &hi[1], &lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], &hi[2], &lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], &hi[3], &lo[3]);
#pragma unroll
      for (int db2 = 0; db2 < kDBlocks / 2; ++db2) {
        const int mi = lane >> 3;
        uint32_t b[4];
        ldmatrix_x4_trans(b, tV + (kk * 16 + (lane & 7) + ((mi & 1) << 3)) *
                                      S + db2 * 16 + ((mi >> 1) << 3));
        mma_bf16(acc[2 * db2], hi, b[0], b[1]);
        mma_bf16(acc[2 * db2], lo, b[0], b[1]);
        mma_bf16(acc[2 * db2 + 1], hi, b[2], b[3]);
        mma_bf16(acc[2 * db2 + 1], lo, b[2], b[3]);
      }
    }
    __syncthreads();   // this buffer is refilled at iteration t + 1
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(kFullMask, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(kFullMask, l_run[i], 2);
    l_run[i] = fmaxf(l_run[i], kLFloor);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    if (row >= sq) continue;
    __nv_bfloat16* out = o + base_q + static_cast<size_t>(row) * D;
#pragma unroll
    for (int db = 0; db < kDBlocks; ++db) {
      const __nv_bfloat162 val = __floats2bfloat162_rn(
          acc[db][2 * i] / l_run[i], acc[db][2 * i + 1] / l_run[i]);
      *reinterpret_cast<__nv_bfloat162*>(out + db * 8 + 2 * (lane & 3)) = val;
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 route
// ---------------------------------------------------------------------------

constexpr int kRowsF = 32;                 // q rows per CTA
constexpr int kTpr = 4;                    // threads per q row
constexpr int kThreadsF = kRowsF * kTpr;   // 128
constexpr int kBcF = 32;                   // kv rows per tile

template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int row0, int n_rows) {
  constexpr int kVec = D / 4;
  for (int c = threadIdx.x; c < kBcF * kVec; c += kThreadsF) {
    const int r = c / kVec;
    const int row = row0 + r;
    const float4 val = row < n_rows
        ? reinterpret_cast<const float4*>(src + static_cast<size_t>(row) * D)[c % kVec]
        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    reinterpret_cast<float4*>(dst)[c] = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsF)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int sq,
                 int skv, int causal, float scale) {
  constexpr int E = D / kTpr;      // dims per thread: g + kTpr * i
  __shared__ __align__(16) float sK[kBcF * D];
  __shared__ __align__(16) float sV[kBcF * D];
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRowsF;
  const int g = threadIdx.x % kTpr;
  const int row = q0 + threadIdx.x / kTpr;
  const bool row_ok = row < sq;
  const size_t base_q = static_cast<size_t>(bh) * sq * D;
  const size_t base_kv = static_cast<size_t>(bh) * skv * D;
  const float* qrow = q + base_q + static_cast<size_t>(row_ok ? row : 0) * D;

  float qr[E], acc[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    qr[i] = row_ok ? qrow[g + kTpr * i] : 0.0f;
    acc[i] = 0.0f;
  }
  float m_run = kNegInf, l_run = 0.0f;

  int n_tiles = (skv + kBcF - 1) / kBcF;
  if (causal) n_tiles = min(n_tiles, (q0 + kRowsF - 1) / kBcF + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * kBcF;
    __syncthreads();
    load_tile_f32<D>(sK, k + base_kv, kv0, skv);
    load_tile_f32<D>(sV, v + base_kv, kv0, skv);
    __syncthreads();

    float s[kBcF];
    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < kBcF; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < E; ++i) dot = fmaf(qr[i], sK[j * D + g + kTpr * i], dot);
      dot += __shfl_xor_sync(kFullMask, dot, 1);
      dot += __shfl_xor_sync(kFullMask, dot, 2);
      const int col = kv0 + j;
      const bool ok = col < skv && (!causal || col <= row);
      s[j] = ok ? dot * scale : kNegInf;
      m_cur = fmaxf(m_cur, s[j]);
    }
    const float m_new = fmaxf(m_run, m_cur);
    const float alpha = expf(m_run - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < kBcF; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l_run = alpha * l_run + psum;
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < kBcF; ++j) {
#pragma unroll
      for (int i = 0; i < E; ++i)
        acc[i] = fmaf(s[j], sV[j * D + g + kTpr * i], acc[i]);
    }
  }
  if (!row_ok) return;
  const float l = fmaxf(l_run, kLFloor);
  float* out = o + base_q + static_cast<size_t>(row) * D;
#pragma unroll
  for (int i = 0; i < E; ++i) out[g + kTpr * i] = acc[i] / l;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int bh,
                int sq, int skv, int causal, float scale, cudaStream_t s) {
  constexpr int bytes = smem_bytes_bf16<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBr - 1) / kBr, bh);
  flash_bf16_kernel<D><<<grid, kThreadsB, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq,
      skv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int bh,
               int sq, int skv, int causal, float scale, cudaStream_t s) {
  const dim3 grid((sq + kRowsF - 1) / kRowsF, bh);
  flash_f32_kernel<D><<<grid, kThreadsF, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, skv, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, o: (bh, sq, d); k, v: (bh, skv, d); contiguous, 16-byte aligned, all
// bf16 (flash_fwd_bf16) or all fp32 (flash_fwd_f32); d in {32, 64, 128};
// bh <= 65535; scale = d^-0.5 as fp32.
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                   int bh, int sq, int skv, int d, int causal, float scale,
                   int sms, void* stream) {
  (void)sms;
  if (bh == 0 || sq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_bf16<32>(q, k, v, o, bh, sq, skv, causal, scale, s);
    case 64: return launch_bf16<64>(q, k, v, o, bh, sq, skv, causal, scale, s);
    case 128: return launch_bf16<128>(q, k, v, o, bh, sq, skv, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                  int bh, int sq, int skv, int d, int causal, float scale,
                  int sms, void* stream) {
  (void)sms;
  if (bh == 0 || sq == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_f32<32>(q, k, v, o, bh, sq, skv, causal, scale, s);
    case 64: return launch_f32<64>(q, k, v, o, bh, sq, skv, causal, scale, s);
    case 128: return launch_f32<128>(q, k, v, o, bh, sq, skv, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
