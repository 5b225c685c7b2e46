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
//   embedding, ~46.1 us at 3.35 TB/s. grid.y walks the blocks, grid.x a
//   grid-stride sweep over the block's elements, four per thread per step.
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
//   at 3.35 TB/s. The same grid-stride sweep; each element is read and
//   written by one thread, so p' and m' may alias p and m.
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

__global__ void __launch_bounds__(kThreads)
correct_apply_kernel(const float* __restrict__ u, const float* __restrict__ v,
                     const float* __restrict__ cu,
                     const float* __restrict__ cv, float* __restrict__ out,
                     long long blocks, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long l = blockIdx.y; l < blocks; l += gridDim.y) {
    const float a = cu[l];
    const float b = cv[l];
    const float* ub = u + l * n;
    const float* vb = v + l * n;
    float* ob = out + l * n;
    long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
      float x[kUnroll], y[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        x[k] = ub[i + k * stride];
        y[k] = vb[i + k * stride];
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) ob[i + k * stride] = a * x[k] + b * y[k];
    }
    for (; i < n; i += stride) ob[i] = a * ub[i] + b * vb[i];
  }
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

__global__ void __launch_bounds__(kThreads)
outer_update_kernel(const float* p, const float* m,
                    const float* __restrict__ g, float* p_out, float* m_out,
                    long long n, float eta, float mu, float rho) {
  const float one_minus_mu = 1.0f - mu;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    float a[kUnroll], b[kUnroll], c[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      a[k] = p[i + k * stride];
      b[k] = m[i + k * stride];
      c[k] = g[i + k * stride];
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      nesterov_one(a[k], b[k], c[k], eta, mu, one_minus_mu, rho,
                   &p_out[i + k * stride], &m_out[i + k * stride]);
  }
  for (; i < n; i += stride)
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

// u, v, out: (blocks, n) fp32; cu, cv: (blocks,) fp32 on the device.
int correct_apply_f32(const float* u, const float* v, const float* cu,
                      const float* cv, float* out, long long blocks,
                      long long n, int sms, void* stream) {
  if (blocks > 0 && n > 0) {
    const int gy = static_cast<int>(blocks < kMaxGridY ? blocks : kMaxGridY);
    const int gx = ctas(n, kUnroll * kThreads, resident(sms) / gy + 1);
    correct_apply_kernel<<<dim3(gx, gy), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        u, v, cu, cv, out, blocks, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// p, m, g, p_out, m_out: n fp32 elements each; p_out/m_out may be p/m.
int outer_update_f32(const float* p, const float* m, const float* g,
                     float* p_out, float* m_out, long long n, float eta,
                     float mu, float rho, int sms, void* stream) {
  if (n > 0) {
    const int gx = ctas(n, kUnroll * kThreads, resident(sms));
    outer_update_kernel<<<gx, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        p, m, g, p_out, m_out, n, eta, mu, rho);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
