// Hopper (sm_90a) kernels of the per-leaf outer step: one parameter tensor
// (a "leaf") at a time, read as its n contiguous fp32 elements with a
// guarded tail (no padding to the reference's (R, 128) TPU tiling). A leaf
// with stacked layer axes is L blocks of n elements, block l at l * n.
//
// block_stats      replaces src/repro/kernels/heloco_correct.py:block_stats
//                   (Pallas _stats_kernel): per block (u.v, u.u, v.v) in fp32
//                   -> (L, 3). The reference's per-tile partials follow its
//                   VMEM tiling and are summed by the caller; vmapped over
//                   the stacked axes, one launch per layer. Here one call
//                   takes all L blocks.
//   Bound: bytes. It reads u and v once: at the largest leaf of
//   tinygpt-15m (the tied embedding, 50257 x 256 = 12,865,792 elements)
//   102.9 MB, ~30.7 us at 3.35 TB/s; 6 flops per 8 bytes. Blocks run in no
//   order, so the reduction is two passes and adds in a fixed order (the
//   same bits on every run): pass 1 splits each block into C chunks, one
//   256-thread CTA per chunk, each thread strides over the chunk four loads
//   at a time (independent loads in flight), and a shuffle tree plus one
//   shared-memory round reduce the CTA to its (dot, uu, vv) partial; pass 2
//   sums a block's C partials with one CTA per block. With C = 1 pass 1
//   writes the result and pass 2 is not launched.
//
// correct_apply    replaces src/repro/kernels/heloco_correct.py:correct_apply
//                   (Pallas _apply_kernel): out = cu * u + cv * v with the
//                   branch scalars cu[l], cv[l] of block l read from device
//                   memory, so the scalars of Alg. 2 never go to the host
//                   (a host read per leaf would add a synchronisation).
//   Bound: bytes. 2 reads + 1 write of the leaf: 154.4 MB at the
//   embedding, ~46.1 us at 3.35 TB/s.
//
// outer_update     replaces src/repro/kernels/outer_update.py:outer_update_2d
//                   (Pallas _outer_kernel): the fused Nesterov step of
//                   Eqs. 17-19 in the reference kernel's order,
//                     g  = g * rho
//                     m' = mu * m + (1 - mu) * g
//                     p' = p - eta * (g + mu * m')
//                   with eta, mu, rho as fp32 values (the reference's (1, 3)
//                   table) and 1 - mu rounded in fp32.
//   Bound: bytes. 3 reads + 2 writes: 257.3 MB at the embedding, ~76.8 us
//   at 3.35 TB/s. Each element is read and written by one thread, so p'
//   and m' may alias p and m.
//
// The two elementwise sweeps stream 16-byte accesses, as the int8 sweeps
// of csrc/quantize.cu do: a lane takes 16 elements a trip (four float4 of
// each input, all loaded before any arithmetic), each warp load and store
// one contiguous 512-byte run. A stacked leaf is walked as one flat range
// of L * n elements; a float4 takes the scalars of its block, or each
// element its own where the four straddle a boundary. The wrappers launch
// a CTA for every 256 units (kernels/tiling.py:plan with no wave), one
// trip each: on an NVIDIA H100 80GB HBM3 at a 700 W power limit, at the
// embedding with every input read from memory (chip_smoke.py --only leaf,
// inputs rotating over copies larger than L2), that takes correct_apply
// 0.0555-0.0556 ms (83 % of its bound; torch.add 0.0553-0.0557 in the
// same calls) and outer_update 0.0895-0.0898 (86 %; torch._fused_sgd_
// 0.0972-0.0974), where the same body walked grid-stride by one resident
// wave (4 and 3 CTAs an SM at 54 and 71 registers) took 0.0565-0.0567 and
// 0.0938-0.0940, and the previous kernels (one float a thread an access)
// 0.0596 and 0.0989. Loads take the default policy: evict-first loads
// (__ldcs) took 0.0579-0.0582 and 0.0935-0.0938 in the grid-stride form;
// stores are evict-first (__stcs), the default policy's outer_update took
// 0.0903 in the one-trip form.
//
// Build with --fmad=false: every product and sum rounds on its own, as in
// the plain PyTorch versions, so correct_apply and outer_update match them
// bit for bit; block_stats adds in another order than the plain version's
// and matches it within fp32 summation error.
//
// C interface for ctypes; every entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
// elements a lane takes per trip of the elementwise sweeps' body
constexpr int kUnit = 16;
constexpr int kMaxGridY = 65535;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

// Sums (a, b, c) over the CTA in a fixed order; thread 0 gets the totals.
__device__ __forceinline__ void cta_sum3(float* a, float* b, float* c) {
  __shared__ float sh[3][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float x = warp_sum(*a), y = warp_sum(*b), z = warp_sum(*c);
  if (lane == 0) {
    sh[0][warp] = x;
    sh[1][warp] = y;
    sh[2][warp] = z;
  }
  __syncthreads();
  if (warp == 0) {
    x = lane < kWarps ? sh[0][lane] : 0.0f;
    y = lane < kWarps ? sh[1][lane] : 0.0f;
    z = lane < kWarps ? sh[2][lane] : 0.0f;
    *a = warp_sum(x);
    *b = warp_sum(y);
    *c = warp_sum(z);
  }
  __syncthreads();  // sh is reused by the next block of a grid-stride loop
}

// Pass 1: CTA (x, y) sums chunk x of block y (and of y + gridDim.y, ...):
// elements [x * chunk, min((x + 1) * chunk, n)). out[(l * C + x) * 3 + k].
__global__ void __launch_bounds__(kThreads)
stats_partial_kernel(const float* __restrict__ u, const float* __restrict__ v,
                     float* __restrict__ out, long long blocks, long long n,
                     long long chunk) {
  const long long begin = static_cast<long long>(blockIdx.x) * chunk;
  const long long end = begin + chunk < n ? begin + chunk : n;
  for (long long l = blockIdx.y; l < blocks; l += gridDim.y) {
    const float* ub = u + l * n;
    const float* vb = v + l * n;
    float dot = 0.0f, uu = 0.0f, vv = 0.0f;
    long long i = begin + threadIdx.x;
    for (; i + (kUnroll - 1) * kThreads < end; i += kUnroll * kThreads) {
      float a[kUnroll], b[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        a[k] = ub[i + k * kThreads];
        b[k] = vb[i + k * kThreads];
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        dot += a[k] * b[k];
        uu += a[k] * a[k];
        vv += b[k] * b[k];
      }
    }
    for (; i < end; i += kThreads) {
      const float a = ub[i];
      const float b = vb[i];
      dot += a * b;
      uu += a * a;
      vv += b * b;
    }
    cta_sum3(&dot, &uu, &vv);
    if (threadIdx.x == 0) {
      float* o = out + (l * gridDim.x + blockIdx.x) * 3;
      o[0] = dot;
      o[1] = uu;
      o[2] = vv;
    }
  }
}

// Pass 2: CTA l sums the C partials of block l in a fixed order.
__global__ void __launch_bounds__(kThreads)
stats_finish_kernel(const float* __restrict__ part, float* __restrict__ out,
                    long long blocks, int chunks) {
  for (long long l = blockIdx.x; l < blocks; l += gridDim.x) {
    const float* p = part + l * chunks * 3;
    float dot = 0.0f, uu = 0.0f, vv = 0.0f;
    for (int c = threadIdx.x; c < chunks; c += kThreads) {
      dot += p[c * 3 + 0];
      uu += p[c * 3 + 1];
      vv += p[c * 3 + 2];
    }
    cta_sum3(&dot, &uu, &vv);
    if (threadIdx.x == 0) {
      out[l * 3 + 0] = dot;
      out[l * 3 + 1] = uu;
      out[l * 3 + 2] = vv;
    }
  }
}

// a * x + b * y, each product and the sum rounded on its own
__device__ __forceinline__ float apply_one(float x, float y, float a,
                                           float b) {
  return a * x + b * y;
}

// Element e of a leaf of blocks of n elements, with its block's scalars.
__device__ __forceinline__ float apply_at(float x, float y, long long e,
                                          long long n,
                                          const float* __restrict__ cu,
                                          const float* __restrict__ cv) {
  const long long l = e / n;
  return apply_one(x, y, cu[l], cv[l]);
}

// Elements e .. e + 3 (x and y); (a, b) the scalars of the only block
// unless kStacked. A stacked leaf looks up the block of e, and each
// element's own block where the four straddle a boundary (n % 4 != 0, or
// n < 4).
template <bool kStacked>
__device__ __forceinline__ float4 apply4(float4 x, float4 y, long long e,
                                         long long n,
                                         const float* __restrict__ cu,
                                         const float* __restrict__ cv,
                                         float a, float b) {
  if (kStacked) {
    const long long l = e / n;
    if (e + 3 >= (l + 1) * n)
      return make_float4(apply_at(x.x, y.x, e, n, cu, cv),
                         apply_at(x.y, y.y, e + 1, n, cu, cv),
                         apply_at(x.z, y.z, e + 2, n, cu, cv),
                         apply_at(x.w, y.w, e + 3, n, cu, cv));
    a = cu[l];
    b = cv[l];
  }
  return make_float4(apply_one(x.x, y.x, a, b), apply_one(x.y, y.y, a, b),
                     apply_one(x.z, y.z, a, b), apply_one(x.w, y.w, a, b));
}

// The streaming body of both elementwise sweeps, a grid-stride walk over
// a leaf's blocks * n elements as one flat range (the int8 sweeps' layout,
// csrc/quantize.cu): in trip t CTA c takes the 16-element units
// [(t * grid + c) * 256, ... + 256), its warp w the 32 of them from 32 w
// on, 512 elements; lane l loads the warp's float4 l, l + 32, l + 64 and
// l + 96 of each input, every load and store of the warp one contiguous
// 512-byte run, all loads of a trip before any arithmetic. The wrappers'
// grid covers the units in one trip. Then the elements from 16 * units on
// (all of them when units = 0: a pointer not 16-byte aligned), one by one
// over every thread of the grid. u and v go through the read-only path
// (out never aliases them).
template <bool kStacked>
__global__ void __launch_bounds__(kThreads)
correct_apply_kernel(const float* __restrict__ u, const float* __restrict__ v,
                     const float* __restrict__ cu,
                     const float* __restrict__ cv, float* __restrict__ out,
                     long long total, long long n, long long units) {
  const float a = cu[0], b = cv[0];
  const float4* u4 = reinterpret_cast<const float4*>(u);
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float4* o4 = reinterpret_cast<float4*>(out);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long ub = static_cast<long long>(blockIdx.x) * kThreads + 32 * warp;
       ub < units; ub += step) {
    float4 x[4], y[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long f = 4 * ub + lane + 32 * k;
      x[k] = f < 4 * units ? u4[f] : zero;
      y[k] = f < 4 * units ? v4[f] : zero;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long f = 4 * ub + lane + 32 * k;
      if (f < 4 * units)
        __stcs(o4 + f, apply4<kStacked>(x[k], y[k], 4 * f, n, cu, cv, a, b));
    }
  }
  for (long long i = units * kUnit + blockIdx.x * kThreads + threadIdx.x;
       i < total; i += step)
    out[i] = kStacked ? apply_at(u[i], v[i], i, n, cu, cv)
                      : apply_one(u[i], v[i], a, b);
}

__device__ __forceinline__ void nesterov_one(float p, float m, float g,
                                             float eta, float mu,
                                             float one_minus_mu, float rho,
                                             float* p_new, float* m_new) {
  const float gr = g * rho;
  const float mn = mu * m + one_minus_mu * gr;
  *m_new = mn;
  *p_new = p - eta * (gr + mu * mn);
}

__device__ __forceinline__ void nesterov4(float4 p, float4 m, float4 g,
                                          float eta, float mu,
                                          float one_minus_mu, float rho,
                                          float4* p_new, float4* m_new) {
  nesterov_one(p.x, m.x, g.x, eta, mu, one_minus_mu, rho, &p_new->x, &m_new->x);
  nesterov_one(p.y, m.y, g.y, eta, mu, one_minus_mu, rho, &p_new->y, &m_new->y);
  nesterov_one(p.z, m.z, g.z, eta, mu, one_minus_mu, rho, &p_new->z, &m_new->z);
  nesterov_one(p.w, m.w, g.w, eta, mu, one_minus_mu, rho, &p_new->w, &m_new->w);
}

// correct_apply_kernel's walk over (p, m, g) -> (p', m'). Each float4, and
// each element of the tail, is read and then written by one thread, so
// p_out and m_out may be p and m (no __restrict__ on the four; the loads
// are coherent, not through the read-only path).
__global__ void __launch_bounds__(kThreads)
outer_update_kernel(const float* p, const float* m,
                    const float* __restrict__ g, float* p_out, float* m_out,
                    long long n, long long units, float eta, float mu,
                    float rho) {
  const float one_minus_mu = 1.0f - mu;
  const float4* p4 = reinterpret_cast<const float4*>(p);
  const float4* m4 = reinterpret_cast<const float4*>(m);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* po4 = reinterpret_cast<float4*>(p_out);
  float4* mo4 = reinterpret_cast<float4*>(m_out);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long ub = static_cast<long long>(blockIdx.x) * kThreads + 32 * warp;
       ub < units; ub += step) {
    float4 a[4], b[4], c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long f = 4 * ub + lane + 32 * k;
      a[k] = f < 4 * units ? p4[f] : zero;
      b[k] = f < 4 * units ? m4[f] : zero;
      c[k] = f < 4 * units ? g4[f] : zero;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long f = 4 * ub + lane + 32 * k;
      float4 pn, mn;
      nesterov4(a[k], b[k], c[k], eta, mu, one_minus_mu, rho, &pn, &mn);
      if (f < 4 * units) {
        __stcs(mo4 + f, mn);
        __stcs(po4 + f, pn);
      }
    }
  }
  for (long long i = units * kUnit + blockIdx.x * kThreads + threadIdx.x;
       i < n; i += step)
    nesterov_one(p[i], m[i], g[i], eta, mu, one_minus_mu, rho, &p_out[i],
                 &m_out[i]);
}

// CTAs for `items` work items at `per_cta` each, at most `cap`, at least 1.
int ctas(long long items, long long per_cta, long long cap) {
  long long c = (items + per_cta - 1) / per_cta;
  if (c > cap) c = cap;
  return static_cast<int>(c < 1 ? 1 : c);
}

// sms: the device's SM count, looked up once per device by the caller;
// 8 resident CTAs of 256 threads fill one SM.
long long resident(int sms) { return 8LL * sms; }

}  // namespace

extern "C" {

// u, v: (blocks, n) fp32; part: (blocks * chunks, 3) scratch, unused when
// chunks == 1; out: (blocks, 3). chunks comes from the wrapper, which
// sizes the scratch.
int block_stats_f32(const float* u, const float* v, float* part, float* out,
                    long long blocks, long long n, int chunks, int sms,
                    void* stream) {
  if (blocks > 0 && chunks > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long chunk = (n + chunks - 1) / chunks;
    const int gy = static_cast<int>(blocks < kMaxGridY ? blocks : kMaxGridY);
    stats_partial_kernel<<<dim3(chunks, gy), kThreads, 0, s>>>(
        u, v, chunks == 1 ? out : part, blocks, n, chunk);
    if (chunks > 1) {
      const int gx = ctas(blocks, 1, resident(sms));
      stats_finish_kernel<<<gx, kThreads, 0, s>>>(part, out, blocks, chunks);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The resident CTAs of kThreads threads one SM holds of correct_apply
// (one block, stacked) and of outer_update, from the occupancy query
// (chip_smoke.py's build report prints them).
int leaf_ctas_per_sm(int* apply, int* apply_stacked, int* outer) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      apply, correct_apply_kernel<false>, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        apply_stacked, correct_apply_kernel<true>, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        outer, outer_update_kernel, kThreads, 0);
  return static_cast<int>(err);
}

// u, v, out: (blocks, n) fp32; cu, cv: (blocks,) fp32 on the device.
// units: 16-element units of the body (u, v and out 16-byte aligned),
// walked by grid CTAs; both come from the wrapper (kernels/tiling.py:plan).
int correct_apply_f32(const float* u, const float* v, const float* cu,
                      const float* cv, float* out, long long blocks,
                      long long n, long long units, int grid, int sms,
                      void* stream) {
  (void)sms;
  if (blocks > 0 && n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (blocks == 1)
      correct_apply_kernel<false><<<grid, kThreads, 0, s>>>(
          u, v, cu, cv, out, n, n, units);
    else
      correct_apply_kernel<true><<<grid, kThreads, 0, s>>>(
          u, v, cu, cv, out, blocks * n, n, units);
  }
  return static_cast<int>(cudaGetLastError());
}

// p, m, g, p_out, m_out: n fp32 elements each; p_out/m_out may be p/m.
// units and grid as for correct_apply_f32.
int outer_update_f32(const float* p, const float* m, const float* g,
                     float* p_out, float* m_out, long long n, long long units,
                     int grid, float eta, float mu, float rho, int sms,
                     void* stream) {
  (void)sms;
  if (n > 0)
    outer_update_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        p, m, g, p_out, m_out, n, units, eta, mu, rho);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
