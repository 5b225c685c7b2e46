// Hopper (sm_90a) kernels for the packed (R, 128) fp32 arrival buffer.
//
// packed_row_stats  replaces src/repro/kernels/packed.py:packed_row_stats
//                   (Pallas): per-row (d.m, d.d, m.m) partials. Stored
//                   planar, (3, R): the wrapper returns its (R, 3)
//                   transpose, and the per-block segment sum reads each
//                   plane as one contiguous vector.
//   Bound: bytes. At tinygpt-15m's R = 125,128 it reads two 64.07 MB
//   buffers and writes 1.50 MB, 129.6 MB in all: ~38.7 us at 3.35 TB/s.
//   Under 1 flop per byte, so the design only has to stream: one warp per
//   row, each lane loads one 16-byte float4 of d and of m (a warp reads a
//   whole 512-byte row, coalesced), and three shuffle-xor trees reduce the
//   row; lane 0 writes the row's three sums, one to each plane.
//
// packed_correct_outer replaces src/repro/kernels/packed.py:
//                   packed_correct_outer (Pallas _correct_outer_kernel and
//                   _correct_outer_stats_kernel): per element
//                     g  = (cu*d + cv*m) * rho
//                     m' = mu*m + (1-mu)*g
//                     p' = p - eta*(g + mu*m')
//   with cu/cv the branch scalars of the row's block.
//   Bound: bytes. 3 reads + 2 writes of 64.07 MB plus the 0.5 MB row->block
//   map: ~95.8 us at 3.35 TB/s. A grid-stride loop over float4s, each
//   element read once and written once; the per-block scalars are looked
//   up through the (R,) int32 row->block map instead of being materialised
//   as (R, 1) rows. Each thread reads and writes the same index, so the
//   output may alias the input (the server updates p and m in place).
//   kStats adds the per-row moments [d.m, d.d, m.m, |cu*d+cv*m - d|^2] in
//   the same launch; every 32 consecutive float4s are one row and one
//   whole warp, so a shuffle tree reduces them. The p'/m' code is shared
//   by both instantiations, so the stats variant writes the same bits.
//
// packed_correct_outer_quad replaces src/repro/kernels/packed.py:
//                   packed_correct_outer_quad (Pallas _correct_outer_quad_kernel
//                   and its stats twin): DC-ASGD's compensation term before
//                   the same Nesterov step,
//                     g  = (cu*d + cv*m + cq*d*d*m) * rho
//                   summed left to right as the reference writes it:
//                   ((cu*d + cv*m) + ((cq*d)*d)*m).
//   Bound: bytes. 3 reads + 2 writes of 64.07 MB plus the map: ~95.8 us at
//   3.35 TB/s; 7 more flops per element than #2 keep it far under one flop
//   per byte. Same grid-stride float4 sweep as packed_correct_outer.
//
// packed_correct_outer_acc replaces src/repro/kernels/packed.py:
//                   packed_correct_outer_acc (Pallas _correct_outer_acc_kernel
//                   and its stats twin): the accumulator schedule of
//                   delayed Nesterov and FedBuff,
//                     g   = (cu*d + cv*m) * rho;   acc = b + g
//                     m'  = am*m + bm*acc;         b'  = ab*acc
//                     p'  = p - eta*((cg*g + ca*acc) + cm*m')
//   Bound: bytes. 4 reads + 3 writes of 64.07 MB plus the map, ~449.0 MB:
//   ~134 us at 3.35 TB/s. The eight schedule scalars come by value (the
//   boundary arrivals of a buffered method toggle them); p, m and b may all
//   alias their outputs.
//
// packed_rowabs    replaces src/repro/kernels/packed.py:packed_rowabs
//                   (Pallas _rowabs_kernel): per-row max|x| -> (R,). The max
//                   propagates NaN, as jnp.max does (fmaxf would drop it).
//   Bound: bytes. Reads 64.07 MB, writes 0.50 MB at R = 125,128: ~19.3 us
//   at 3.35 TB/s. One warp per row as in row_stats: a float4 per lane, then
//   a shuffle-xor max tree; lane 0 stores the row's max.
//
// packed_quant     replaces src/repro/kernels/packed.py:packed_quant (Pallas
//                   _quant_kernel): q = clip(rint(x / s), -127, 127) to int8,
//                   s the scale of the row's block, looked up through the
//                   (R,) int32 row->block map (the fused sweeps' scheme)
//                   instead of an (R, 1) scale table.
//   Bound: bytes. Reads 64.07 MB of x plus the 0.50 MB map, writes 16.02 MB
//   of int8: ~24.1 us at 3.35 TB/s. A grid-stride sweep, a float4 in and a
//   char4 out per thread. x / s is IEEE division (__fdiv_rn, never a
//   reciprocal multiply) and rintf rounds half to even, as jnp.round does.
//
// packed_dequant   replaces src/repro/kernels/packed.py:packed_dequant
//                   (Pallas _dequant_kernel): x = q * s, s as in quant.
//   Bound: bytes. Reads 16.02 MB of int8 plus the map, writes 64.07 MB:
//   ~24.1 us at 3.35 TB/s. A char4 in and a float4 out per thread.
//
// The three stay separate launches, as the reference's round-trip is: the
// int8 tensor between quant and dequant is the wire payload.
//
// packed_multi_correct_outer, _quad, _acc replace src/repro/kernels/
//                   packed.py:packed_multi_correct_outer{,_quad,_acc} (Pallas
//                   _multi_correct_outer{,_quad,_acc}_kernel): K chained
//                   applications of #2, #3 or #4 in one launch, for the K
//                   arrivals of one flush of the server's commit buffer.
//   Bound: bytes. p and m (and b) are read once and written once, each of
//   the K deltas is read once: at K = 4 and R = 125,128, 6 reads + 2 writes
//   of 64.07 MB plus the map (~513 MB, ~153 us at 3.35 TB/s) for the plain
//   and quadratic sweeps, 7 reads + 3 writes (~641 MB, ~191 us) for the
//   accumulator one, where K sequential launches would move (3K+2K) buffers.
//   Each thread keeps its float4 of p and m (and b) in registers across the
//   K applications and reads Delta_j from the (K, R, 128) stack. K is a
//   runtime argument. The per-block coefficients are (K, B), looked up
//   through the row->block map, and application j's scalars are row j of a
//   (K, n) fp32 table on the device ([eta, mu, rho], or the accumulator's
//   eight). Application j runs the very function of the single-arrival
//   kernel (update_one, quad_one, acc_one), so with --fmad=false the chain
//   equals K sequential launches of that kernel bit for bit. The stats
//   variants write (K, R, 4) moments, slice j against m as of application j.
//
// packed_multi_gram replaces src/repro/kernels/packed.py:packed_multi_gram
//                   (Pallas _multi_gram_kernel): per row, the (K+1)(K+2)/2
//                   lane sums of the pairwise products of the basis [m0,
//                   Delta_1..Delta_K], in the reference's (a <= b) column
//                   order, stored planar, (P, R), so the per-block reduction
//                   is one 1-D segment sum, as for the row stats.
//   Bound: bytes. At K = 4: 5 reads of 64.07 MB and 15 columns of R floats
//   out, ~328 MB: ~98 us at 3.35 TB/s. One warp per row as in row_stats; each
//   lane holds one float4 of each of the K+1 basis vectors in registers (K
//   is a template argument, 1..8) and a shuffle tree reduces each product.
//
// The stats variants of #2-#4 share write_moments: the per-row moments
// [d.m, d.d, m.m, |corr - d|^2] of the unweighted correction, reduced by a
// warp (32 consecutive float4s are one row) after the update is stored, so
// they cannot change the update's bits.
//
// Build with --fmad=false: every product and sum then rounds on its own,
// as in the plain PyTorch version, so p'/m' match it bit for bit.
//
// C interface for ctypes; every entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerRow = 32;  // 128 fp32 lanes = 32 float4 = one warp
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// sms: the device's SM count, looked up once per device by the caller.
int grid_for(long long work_items, int items_per_block, int sms) {
  long long blocks = (work_items + items_per_block - 1) / items_per_block;
  long long cap = 8LL * sms;  // 8 resident blocks of 256 threads per SM
  return static_cast<int>(blocks < cap ? blocks : cap);
}

__global__ void __launch_bounds__(kThreads)
row_stats_kernel(const float4* __restrict__ u, const float4* __restrict__ v,
                 float* __restrict__ out, long long rows) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  for (long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                       (threadIdx.x >> 5);
       row < rows; row += warps) {
    const float4 a = u[row * kVecPerRow + lane];
    const float4 b = v[row * kVecPerRow + lane];
    const float dot = warp_sum(dot4(a, b));
    const float uu = warp_sum(dot4(a, a));
    const float vv = warp_sum(dot4(b, b));
    if (lane == 0) {
      out[row] = dot;
      out[rows + row] = uu;
      out[2 * rows + row] = vv;
    }
  }
}

// Per-row moments [d.m, d.d, m.m, |c - d|^2] of one row held by a whole warp
// (one float4 of d, m and the correction c per lane); lane 0 stores them.
__device__ __forceinline__ void write_moments(float* stats, long long row,
                                              float4 d, float4 m, float4 c) {
  const float4 e = make_float4(c.x - d.x, c.y - d.y, c.z - d.z, c.w - d.w);
  const float dm = warp_sum(dot4(d, m));
  const float dd = warp_sum(dot4(d, d));
  const float mm = warp_sum(dot4(m, m));
  const float ee = warp_sum(dot4(e, e));
  if ((threadIdx.x & 31) == 0) {
    stats[row * 4 + 0] = dm;
    stats[row * 4 + 1] = dd;
    stats[row * 4 + 2] = mm;
    stats[row * 4 + 3] = ee;
  }
}

__device__ __forceinline__ float update_one(float p, float m, float d, float cu,
                                            float cv, float eta, float mu,
                                            float one_minus_mu, float rho,
                                            float* m_new, float* corr) {
  const float c = cu * d + cv * m;
  const float g = c * rho;
  const float mn = mu * m + one_minus_mu * g;
  *m_new = mn;
  *corr = c;
  return p - eta * (g + mu * mn);
}

template <bool kStats>
__global__ void __launch_bounds__(kThreads)
correct_outer_kernel(const float4* p, const float4* m,
                     const float4* __restrict__ d,
                     const float* __restrict__ cu,
                     const float* __restrict__ cv,
                     const int* __restrict__ row_block, float4* p_out,
                     float4* m_out, float* __restrict__ stats,
                     long long n_vec, float eta, float mu, float rho) {
  const float one_minus_mu = 1.0f - mu;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_vec; i += stride) {
    const long long row = i / kVecPerRow;
    const int blk = row_block[row];
    const float a = cu[blk];
    const float b = cv[blk];
    const float4 pv = p[i];
    const float4 mv = m[i];
    const float4 dv = d[i];
    float4 pn, mn, cr;
    pn.x = update_one(pv.x, mv.x, dv.x, a, b, eta, mu, one_minus_mu, rho, &mn.x, &cr.x);
    pn.y = update_one(pv.y, mv.y, dv.y, a, b, eta, mu, one_minus_mu, rho, &mn.y, &cr.y);
    pn.z = update_one(pv.z, mv.z, dv.z, a, b, eta, mu, one_minus_mu, rho, &mn.z, &cr.z);
    pn.w = update_one(pv.w, mv.w, dv.w, a, b, eta, mu, one_minus_mu, rho, &mn.w, &cr.w);
    p_out[i] = pn;
    m_out[i] = mn;
    if (kStats) write_moments(stats, row, dv, mv, cr);
  }
}

__device__ __forceinline__ float quad_one(float p, float m, float d, float cu,
                                          float cv, float cq, float eta,
                                          float mu, float one_minus_mu,
                                          float rho, float* m_new, float* corr) {
  const float c = (cu * d + cv * m) + cq * d * d * m;
  const float g = c * rho;
  const float mn = mu * m + one_minus_mu * g;
  *m_new = mn;
  *corr = c;
  return p - eta * (g + mu * mn);
}

template <bool kStats>
__global__ void __launch_bounds__(kThreads)
correct_outer_quad_kernel(const float4* p, const float4* m,
                          const float4* __restrict__ d,
                          const float* __restrict__ cu,
                          const float* __restrict__ cv,
                          const float* __restrict__ cq,
                          const int* __restrict__ row_block, float4* p_out,
                          float4* m_out, float* __restrict__ stats,
                          long long n_vec, float eta, float mu, float rho) {
  const float one_minus_mu = 1.0f - mu;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_vec; i += stride) {
    const long long row = i / kVecPerRow;
    const int blk = row_block[row];
    const float a = cu[blk];
    const float b = cv[blk];
    const float q = cq[blk];
    const float4 pv = p[i];
    const float4 mv = m[i];
    const float4 dv = d[i];
    float4 pn, mn, cr;
    pn.x = quad_one(pv.x, mv.x, dv.x, a, b, q, eta, mu, one_minus_mu, rho, &mn.x, &cr.x);
    pn.y = quad_one(pv.y, mv.y, dv.y, a, b, q, eta, mu, one_minus_mu, rho, &mn.y, &cr.y);
    pn.z = quad_one(pv.z, mv.z, dv.z, a, b, q, eta, mu, one_minus_mu, rho, &mn.z, &cr.z);
    pn.w = quad_one(pv.w, mv.w, dv.w, a, b, q, eta, mu, one_minus_mu, rho, &mn.w, &cr.w);
    p_out[i] = pn;
    m_out[i] = mn;
    if (kStats) write_moments(stats, row, dv, mv, cr);
  }
}

// The accumulator schedule's scalars, by value.
struct AccScalars {
  float eta, rho, am, bm, ab, cg, cm, ca;
};

__device__ __forceinline__ float acc_one(float p, float m, float b, float d,
                                         float cu, float cv,
                                         const AccScalars& s, float* m_new,
                                         float* b_new, float* corr) {
  const float c = cu * d + cv * m;
  const float g = c * s.rho;
  const float acc = b + g;
  const float mn = s.am * m + s.bm * acc;
  *m_new = mn;
  *b_new = s.ab * acc;
  *corr = c;
  return p - s.eta * ((s.cg * g + s.ca * acc) + s.cm * mn);
}

template <bool kStats>
__global__ void __launch_bounds__(kThreads)
correct_outer_acc_kernel(const float4* p, const float4* m, const float4* b,
                         const float4* __restrict__ d,
                         const float* __restrict__ cu,
                         const float* __restrict__ cv,
                         const int* __restrict__ row_block, float4* p_out,
                         float4* m_out, float4* b_out,
                         float* __restrict__ stats, long long n_vec,
                         AccScalars s) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_vec; i += stride) {
    const long long row = i / kVecPerRow;
    const int blk = row_block[row];
    const float x = cu[blk];
    const float y = cv[blk];
    const float4 pv = p[i];
    const float4 mv = m[i];
    const float4 bv = b[i];
    const float4 dv = d[i];
    float4 pn, mn, bn, cr;
    pn.x = acc_one(pv.x, mv.x, bv.x, dv.x, x, y, s, &mn.x, &bn.x, &cr.x);
    pn.y = acc_one(pv.y, mv.y, bv.y, dv.y, x, y, s, &mn.y, &bn.y, &cr.y);
    pn.z = acc_one(pv.z, mv.z, bv.z, dv.z, x, y, s, &mn.z, &bn.z, &cr.z);
    pn.w = acc_one(pv.w, mv.w, bv.w, dv.w, x, y, s, &mn.w, &bn.w, &cr.w);
    p_out[i] = pn;
    m_out[i] = mn;
    b_out[i] = bn;
    if (kStats) write_moments(stats, row, dv, mv, cr);
  }
}

// K chained applications of update_one (kQuad: quad_one) per element; p and
// m stay in registers. hp: (K, 3) rows [eta, mu, rho]; cu/cv/cq: (K, nb).
template <bool kStats, bool kQuad>
__global__ void __launch_bounds__(kThreads)
multi_correct_outer_kernel(const float4* p, const float4* m,
                           const float4* __restrict__ d,
                           const float* __restrict__ cu,
                           const float* __restrict__ cv,
                           const float* __restrict__ cq,
                           const int* __restrict__ row_block,
                           const float* __restrict__ hp, float4* p_out,
                           float4* m_out, float* __restrict__ stats,
                           long long n_vec, int k, int nb) {
  const long long rows = n_vec / kVecPerRow;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_vec; i += stride) {
    const long long row = i / kVecPerRow;
    const int blk = row_block[row];
    float4 pv = p[i];
    float4 mv = m[i];
    for (int j = 0; j < k; ++j) {
      const float eta = hp[3 * j], mu = hp[3 * j + 1], rho = hp[3 * j + 2];
      const float one_minus_mu = 1.0f - mu;
      const float a = cu[j * nb + blk];
      const float b = cv[j * nb + blk];
      const float4 dv = d[j * n_vec + i];
      float4 pn, mn, cr;
      if (kQuad) {
        const float q = cq[j * nb + blk];
        pn.x = quad_one(pv.x, mv.x, dv.x, a, b, q, eta, mu, one_minus_mu, rho, &mn.x, &cr.x);
        pn.y = quad_one(pv.y, mv.y, dv.y, a, b, q, eta, mu, one_minus_mu, rho, &mn.y, &cr.y);
        pn.z = quad_one(pv.z, mv.z, dv.z, a, b, q, eta, mu, one_minus_mu, rho, &mn.z, &cr.z);
        pn.w = quad_one(pv.w, mv.w, dv.w, a, b, q, eta, mu, one_minus_mu, rho, &mn.w, &cr.w);
      } else {
        pn.x = update_one(pv.x, mv.x, dv.x, a, b, eta, mu, one_minus_mu, rho, &mn.x, &cr.x);
        pn.y = update_one(pv.y, mv.y, dv.y, a, b, eta, mu, one_minus_mu, rho, &mn.y, &cr.y);
        pn.z = update_one(pv.z, mv.z, dv.z, a, b, eta, mu, one_minus_mu, rho, &mn.z, &cr.z);
        pn.w = update_one(pv.w, mv.w, dv.w, a, b, eta, mu, one_minus_mu, rho, &mn.w, &cr.w);
      }
      if (kStats) write_moments(stats + j * rows * 4, row, dv, mv, cr);
      pv = pn;
      mv = mn;
    }
    p_out[i] = pv;
    m_out[i] = mv;
  }
}

// K chained applications of acc_one; p, m and b stay in registers. hp: (K, 8)
// rows [eta, rho, am, bm, ab, cg, cm, ca], so a boundary arrival inside the
// batch toggles its own row.
template <bool kStats>
__global__ void __launch_bounds__(kThreads)
multi_correct_outer_acc_kernel(const float4* p, const float4* m,
                               const float4* b, const float4* __restrict__ d,
                               const float* __restrict__ cu,
                               const float* __restrict__ cv,
                               const int* __restrict__ row_block,
                               const float* __restrict__ hp, float4* p_out,
                               float4* m_out, float4* b_out,
                               float* __restrict__ stats, long long n_vec,
                               int k, int nb) {
  const long long rows = n_vec / kVecPerRow;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_vec; i += stride) {
    const long long row = i / kVecPerRow;
    const int blk = row_block[row];
    float4 pv = p[i];
    float4 mv = m[i];
    float4 bv = b[i];
    for (int j = 0; j < k; ++j) {
      const float* h = hp + 8 * j;
      const AccScalars s{h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7]};
      const float x = cu[j * nb + blk];
      const float y = cv[j * nb + blk];
      const float4 dv = d[j * n_vec + i];
      float4 pn, mn, bn, cr;
      pn.x = acc_one(pv.x, mv.x, bv.x, dv.x, x, y, s, &mn.x, &bn.x, &cr.x);
      pn.y = acc_one(pv.y, mv.y, bv.y, dv.y, x, y, s, &mn.y, &bn.y, &cr.y);
      pn.z = acc_one(pv.z, mv.z, bv.z, dv.z, x, y, s, &mn.z, &bn.z, &cr.z);
      pn.w = acc_one(pv.w, mv.w, bv.w, dv.w, x, y, s, &mn.w, &bn.w, &cr.w);
      if (kStats) write_moments(stats + j * rows * 4, row, dv, mv, cr);
      pv = pn;
      mv = mn;
      bv = bn;
    }
    p_out[i] = pv;
    m_out[i] = mv;
    b_out[i] = bv;
  }
}

// Per-row Gram partials of the basis [m, d_0..d_{T-2}]: column c of the
// (a <= b) order holds row . row of vectors a and b; out is planar (P, R).
template <int T>
__global__ void __launch_bounds__(kThreads)
multi_gram_kernel(const float4* __restrict__ m, const float4* __restrict__ d,
                  float* __restrict__ out, long long rows) {
  const int lane = threadIdx.x & 31;
  const long long n_vec = rows * kVecPerRow;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  for (long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                       (threadIdx.x >> 5);
       row < rows; row += warps) {
    const long long i = row * kVecPerRow + lane;
    float4 v[T];
    v[0] = m[i];
#pragma unroll
    for (int j = 1; j < T; ++j) v[j] = d[(j - 1) * n_vec + i];
    int c = 0;
#pragma unroll
    for (int a = 0; a < T; ++a) {
#pragma unroll
      for (int b = a; b < T; ++b) {
        const float s = warp_sum(dot4(v[a], v[b]));
        if (lane == 0) out[c * rows + row] = s;
        ++c;
      }
    }
  }
}

template <int T>
void launch_multi_gram(const float* m, const float* d, float* out,
                       long long rows, int sms, cudaStream_t s) {
  const int grid = grid_for(rows, kThreads / 32, sms);
  multi_gram_kernel<T><<<grid, kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(m), reinterpret_cast<const float4*>(d),
      out, rows);
}

// NaN-propagating max: a NaN on either side wins, as in jnp.max.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__global__ void __launch_bounds__(kThreads)
rowabs_kernel(const float4* __restrict__ x, float* __restrict__ out,
              long long rows) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  for (long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                       (threadIdx.x >> 5);
       row < rows; row += warps) {
    const float4 a = x[row * kVecPerRow + lane];
    float v = nan_max(nan_max(fabsf(a.x), fabsf(a.y)),
                      nan_max(fabsf(a.z), fabsf(a.w)));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = nan_max(v, __shfl_xor_sync(kFullMask, v, off));
    if (lane == 0) out[row] = v;
  }
}

__device__ __forceinline__ signed char quant_one(float x, float s) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.0f), 127.0f);
  return static_cast<signed char>(__float2int_rn(r));
}

__global__ void __launch_bounds__(kThreads)
quant_kernel(const float4* __restrict__ x, const float* __restrict__ scale,
             const int* __restrict__ row_block, char4* __restrict__ q,
             long long n_vec) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_vec; i += stride) {
    const float s = scale[row_block[i / kVecPerRow]];
    const float4 v = x[i];
    q[i] = make_char4(quant_one(v.x, s), quant_one(v.y, s), quant_one(v.z, s),
                      quant_one(v.w, s));
  }
}

__global__ void __launch_bounds__(kThreads)
dequant_kernel(const char4* __restrict__ q, const float* __restrict__ scale,
               const int* __restrict__ row_block, float4* __restrict__ x,
               long long n_vec) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_vec; i += stride) {
    const float s = scale[row_block[i / kVecPerRow]];
    const char4 v = q[i];
    x[i] = make_float4(static_cast<float>(v.x) * s, static_cast<float>(v.y) * s,
                       static_cast<float>(v.z) * s, static_cast<float>(v.w) * s);
  }
}

}  // namespace

extern "C" {

int packed_row_stats_f32(const float* u, const float* v, float* out,
                         long long rows, int sms, void* stream) {
  if (rows > 0) {
    const int grid = grid_for(rows, kThreads / 32, sms);
    row_stats_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(u), reinterpret_cast<const float4*>(v),
        out, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

int packed_correct_outer_f32(const float* p, const float* m, const float* d,
                             const float* cu, const float* cv,
                             const int* row_block, float* p_out, float* m_out,
                             float* stats, long long rows, float eta, float mu,
                             float rho, int sms, void* stream) {
  const long long n_vec = rows * kVecPerRow;
  if (n_vec > 0) {
    const int grid = grid_for(n_vec, kThreads, sms);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* m4 = reinterpret_cast<const float4*>(m);
    const float4* d4 = reinterpret_cast<const float4*>(d);
    float4* po = reinterpret_cast<float4*>(p_out);
    float4* mo = reinterpret_cast<float4*>(m_out);
    if (stats != nullptr) {
      correct_outer_kernel<true><<<grid, kThreads, 0, s>>>(
          p4, m4, d4, cu, cv, row_block, po, mo, stats, n_vec, eta, mu, rho);
    } else {
      correct_outer_kernel<false><<<grid, kThreads, 0, s>>>(
          p4, m4, d4, cu, cv, row_block, po, mo, nullptr, n_vec, eta, mu, rho);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int packed_correct_outer_quad_f32(const float* p, const float* m,
                                  const float* d, const float* cu,
                                  const float* cv, const float* cq,
                                  const int* row_block, float* p_out,
                                  float* m_out, float* stats, long long rows,
                                  float eta, float mu, float rho, int sms,
                                  void* stream) {
  const long long n_vec = rows * kVecPerRow;
  if (n_vec > 0) {
    const int grid = grid_for(n_vec, kThreads, sms);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* m4 = reinterpret_cast<const float4*>(m);
    const float4* d4 = reinterpret_cast<const float4*>(d);
    float4* po = reinterpret_cast<float4*>(p_out);
    float4* mo = reinterpret_cast<float4*>(m_out);
    if (stats != nullptr) {
      correct_outer_quad_kernel<true><<<grid, kThreads, 0, s>>>(
          p4, m4, d4, cu, cv, cq, row_block, po, mo, stats, n_vec, eta, mu, rho);
    } else {
      correct_outer_quad_kernel<false><<<grid, kThreads, 0, s>>>(
          p4, m4, d4, cu, cv, cq, row_block, po, mo, nullptr, n_vec, eta, mu,
          rho);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int packed_correct_outer_acc_f32(const float* p, const float* m,
                                 const float* b, const float* d,
                                 const float* cu, const float* cv,
                                 const int* row_block, float* p_out,
                                 float* m_out, float* b_out, float* stats,
                                 long long rows, float eta, float rho,
                                 float am, float bm, float ab, float cg,
                                 float cm, float ca, int sms, void* stream) {
  const long long n_vec = rows * kVecPerRow;
  if (n_vec > 0) {
    const int grid = grid_for(n_vec, kThreads, sms);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const AccScalars sc{eta, rho, am, bm, ab, cg, cm, ca};
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* m4 = reinterpret_cast<const float4*>(m);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    const float4* d4 = reinterpret_cast<const float4*>(d);
    float4* po = reinterpret_cast<float4*>(p_out);
    float4* mo = reinterpret_cast<float4*>(m_out);
    float4* bo = reinterpret_cast<float4*>(b_out);
    if (stats != nullptr) {
      correct_outer_acc_kernel<true><<<grid, kThreads, 0, s>>>(
          p4, m4, b4, d4, cu, cv, row_block, po, mo, bo, stats, n_vec, sc);
    } else {
      correct_outer_acc_kernel<false><<<grid, kThreads, 0, s>>>(
          p4, m4, b4, d4, cu, cv, row_block, po, mo, bo, nullptr, n_vec, sc);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// cq == nullptr: the plain sweep; else the quadratic one.
int packed_multi_correct_outer_f32(const float* p, const float* m,
                                   const float* d, const float* cu,
                                   const float* cv, const float* cq,
                                   const int* row_block, const float* hp,
                                   float* p_out, float* m_out, float* stats,
                                   long long rows, int k, int nb, int sms,
                                   void* stream) {
  const long long n_vec = rows * kVecPerRow;
  if (n_vec > 0 && k > 0) {
    const int grid = grid_for(n_vec, kThreads, sms);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* m4 = reinterpret_cast<const float4*>(m);
    const float4* d4 = reinterpret_cast<const float4*>(d);
    float4* po = reinterpret_cast<float4*>(p_out);
    float4* mo = reinterpret_cast<float4*>(m_out);
    if (cq != nullptr) {
      if (stats != nullptr) {
        multi_correct_outer_kernel<true, true><<<grid, kThreads, 0, s>>>(
            p4, m4, d4, cu, cv, cq, row_block, hp, po, mo, stats, n_vec, k, nb);
      } else {
        multi_correct_outer_kernel<false, true><<<grid, kThreads, 0, s>>>(
            p4, m4, d4, cu, cv, cq, row_block, hp, po, mo, nullptr, n_vec, k,
            nb);
      }
    } else if (stats != nullptr) {
      multi_correct_outer_kernel<true, false><<<grid, kThreads, 0, s>>>(
          p4, m4, d4, cu, cv, nullptr, row_block, hp, po, mo, stats, n_vec, k,
          nb);
    } else {
      multi_correct_outer_kernel<false, false><<<grid, kThreads, 0, s>>>(
          p4, m4, d4, cu, cv, nullptr, row_block, hp, po, mo, nullptr, n_vec,
          k, nb);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int packed_multi_correct_outer_acc_f32(const float* p, const float* m,
                                       const float* b, const float* d,
                                       const float* cu, const float* cv,
                                       const int* row_block, const float* hp,
                                       float* p_out, float* m_out,
                                       float* b_out, float* stats,
                                       long long rows, int k, int nb, int sms,
                                       void* stream) {
  const long long n_vec = rows * kVecPerRow;
  if (n_vec > 0 && k > 0) {
    const int grid = grid_for(n_vec, kThreads, sms);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* m4 = reinterpret_cast<const float4*>(m);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    const float4* d4 = reinterpret_cast<const float4*>(d);
    float4* po = reinterpret_cast<float4*>(p_out);
    float4* mo = reinterpret_cast<float4*>(m_out);
    float4* bo = reinterpret_cast<float4*>(b_out);
    if (stats != nullptr) {
      multi_correct_outer_acc_kernel<true><<<grid, kThreads, 0, s>>>(
          p4, m4, b4, d4, cu, cv, row_block, hp, po, mo, bo, stats, n_vec, k,
          nb);
    } else {
      multi_correct_outer_acc_kernel<false><<<grid, kThreads, 0, s>>>(
          p4, m4, b4, d4, cu, cv, row_block, hp, po, mo, bo, nullptr, n_vec, k,
          nb);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// k in 1..8 (the wrapper refuses more); any other k launches nothing and
// returns cudaErrorInvalidValue.
int packed_multi_gram_f32(const float* m, const float* d, float* out,
                          long long rows, int k, int sms, void* stream) {
  if (rows > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (k) {
      case 1: launch_multi_gram<2>(m, d, out, rows, sms, s); break;
      case 2: launch_multi_gram<3>(m, d, out, rows, sms, s); break;
      case 3: launch_multi_gram<4>(m, d, out, rows, sms, s); break;
      case 4: launch_multi_gram<5>(m, d, out, rows, sms, s); break;
      case 5: launch_multi_gram<6>(m, d, out, rows, sms, s); break;
      case 6: launch_multi_gram<7>(m, d, out, rows, sms, s); break;
      case 7: launch_multi_gram<8>(m, d, out, rows, sms, s); break;
      case 8: launch_multi_gram<9>(m, d, out, rows, sms, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int packed_rowabs_f32(const float* x, float* out, long long rows, int sms,
                      void* stream) {
  if (rows > 0) {
    const int grid = grid_for(rows, kThreads / 32, sms);
    rowabs_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(x), out, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

int packed_quant_f32(const float* x, const float* scale, const int* row_block,
                     signed char* q, long long rows, int sms, void* stream) {
  const long long n_vec = rows * kVecPerRow;
  if (n_vec > 0) {
    const int grid = grid_for(n_vec, kThreads, sms);
    quant_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(x), scale, row_block,
        reinterpret_cast<char4*>(q), n_vec);
  }
  return static_cast<int>(cudaGetLastError());
}

int packed_dequant_f32(const signed char* q, const float* scale,
                       const int* row_block, float* x, long long rows, int sms,
                       void* stream) {
  const long long n_vec = rows * kVecPerRow;
  if (n_vec > 0) {
    const int grid = grid_for(n_vec, kThreads, sms);
    dequant_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const char4*>(q), scale, row_block,
        reinterpret_cast<float4*>(x), n_vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
