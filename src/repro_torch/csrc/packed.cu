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

}  // extern "C"
