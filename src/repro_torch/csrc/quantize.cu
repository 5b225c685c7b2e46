// Hopper (sm_90a) kernels of per-tensor int8 quantization: one tensor read
// as its n contiguous fp32 elements with a guarded tail (no padding to the
// reference's (R, 128) TPU tiling), one fp32 scale for the whole tensor.
//
// absmax         replaces src/repro/kernels/quantize.py:absmax (Pallas
//                 _absmax_kernel): max|x| over the tensor -> one fp32 value.
//                 NaN propagates, as in jnp.max. The reference reduces each
//                 (rows, 128) tile in the kernel and the tiles' maxima with
//                 jnp.max outside it.
//   Bound: bytes. One read of x: 51.5 MB at the largest leaf of tinygpt-15m
//   (the tied embedding, 12,865,792 elements), ~15.4 us at 3.35 TB/s; one
//   compare per element. CTAs run in no order, so the reduction is two
//   passes in one C call, as leaf.cu's block_stats: pass 1 has C CTAs (up
//   to 8 per SM), each thread strides over the tensor four float4 loads at a
//   time and a shuffle tree plus one shared-memory round reduce the CTA to
//   its partial; pass 2, one CTA, reduces the C partials. A max is exact in
//   any order, so the result does not depend on C. With C = 1 pass 1
//   writes the result and pass 2 is not launched.
//
// quantize_2d    replaces src/repro/kernels/quantize.py:quantize_2d (Pallas
//                 _quant_kernel and the scale around it): scale =
//                 max(absmax, 1e-12) / 127 and q = clip(rint(x / scale),
//                 -127, 127) as int8. Every thread computes the scale from
//                 the absmax on the device (no host synchronisation) with
//                 the reference's NaN rule (jnp.maximum propagates NaN);
//                 CTA 0 writes it out. A NaN quotient stores 0, as XLA's and
//                 PyTorch's float -> int8 conversions do.
//   Bound: bytes. 4 + 1 bytes per element: 64.3 MB at the embedding,
//   ~19.2 us.
//
// dequantize_2d  replaces src/repro/kernels/quantize.py:dequantize_2d
//                 (Pallas _dequant_kernel): x = q * scale in fp32.
//   Bound: bytes. 1 + 4 bytes per element, as quantize_2d.
//
// Division is IEEE (__fdiv_rn) and rounding half to even (rintf), and the
// source is built with --fmad=false: q and the scale equal the plain
// PyTorch versions' bit for bit, and the dequantized values too (one
// product each). The float4 body runs when the wrapper passes vec = 1 (the
// pointers 16-byte aligned, q's 4-byte aligned); the tail and unaligned
// tensors go element by element.
//
// C interface for ctypes; every entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr unsigned kFullMask = 0xffffffffu;

// NaN-propagating max: a NaN on either side wins, as in jnp.max.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float abs_max4(float m, float4 a) {
  return nan_max(nan_max(m, nan_max(fabsf(a.x), fabsf(a.y))),
                 nan_max(fabsf(a.z), fabsf(a.w)));
}

// Max over the CTA; thread 0 gets it.
__device__ __forceinline__ float cta_max(float x) {
  __shared__ float sh[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = nan_max(x, __shfl_xor_sync(kFullMask, x, off));
  if (lane == 0) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kWarps ? sh[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x = nan_max(x, __shfl_xor_sync(kFullMask, x, off));
  }
  return x;
}

// Pass 1: CTA b writes the max|x| of the elements it strides over to
// out[b]. With vec, the first n / 4 * 4 elements are read as float4.
__global__ void __launch_bounds__(kThreads)
absmax_partial_kernel(const float* __restrict__ x, float* __restrict__ out,
                      long long n, int vec) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  float m = 0.0f;
  long long done = 0;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const long long n4 = n / 4;
    long long i = t;
    for (; i + (kUnroll - 1) * stride < n4; i += kUnroll * stride) {
      float4 a[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) a[k] = x4[i + k * stride];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) m = abs_max4(m, a[k]);
    }
    for (; i < n4; i += stride) m = abs_max4(m, x4[i]);
    done = n4 * 4;
  }
  for (long long i = done + t; i < n; i += stride) m = nan_max(m, fabsf(x[i]));
  m = cta_max(m);
  if (threadIdx.x == 0) out[blockIdx.x] = m;
}

// Pass 2: one CTA reduces the C partials.
__global__ void __launch_bounds__(kThreads)
absmax_finish_kernel(const float* __restrict__ part, float* __restrict__ out,
                     int chunks) {
  float m = 0.0f;
  for (int c = threadIdx.x; c < chunks; c += kThreads) m = nan_max(m, part[c]);
  m = cta_max(m);
  if (threadIdx.x == 0) out[0] = m;
}

// scale = max(absmax, 1e-12) / 127, NaN kept (jnp.maximum's rule).
__device__ __forceinline__ float scale_of(float amax) {
  const float floor = 1e-12f;
  return __fdiv_rn((amax > floor || amax != amax) ? amax : floor, 127.0f);
}

__device__ __forceinline__ signed char quant_one(float x, float s) {
  const float r = rintf(__fdiv_rn(x, s));
  const float c = r != r ? 0.0f : fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<signed char>(__float2int_rn(c));
}

__global__ void __launch_bounds__(kThreads)
quant_kernel(const float* __restrict__ x, const float* __restrict__ amax,
             signed char* __restrict__ q, float* __restrict__ scale,
             long long n, int vec) {
  const float s = scale_of(amax[0]);
  if (blockIdx.x == 0 && threadIdx.x == 0) scale[0] = s;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long done = 0;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    char4* q4 = reinterpret_cast<char4*>(q);
    const long long n4 = n / 4;
    for (long long i = t; i < n4; i += stride) {
      const float4 v = x4[i];
      q4[i] = make_char4(quant_one(v.x, s), quant_one(v.y, s),
                         quant_one(v.z, s), quant_one(v.w, s));
    }
    done = n4 * 4;
  }
  for (long long i = done + t; i < n; i += stride) q[i] = quant_one(x[i], s);
}

__global__ void __launch_bounds__(kThreads)
dequant_kernel(const signed char* __restrict__ q,
               const float* __restrict__ scale, float* __restrict__ x,
               long long n, int vec) {
  const float s = scale[0];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long done = 0;
  if (vec) {
    const char4* q4 = reinterpret_cast<const char4*>(q);
    float4* x4 = reinterpret_cast<float4*>(x);
    const long long n4 = n / 4;
    for (long long i = t; i < n4; i += stride) {
      const char4 v = q4[i];
      x4[i] = make_float4(static_cast<float>(v.x) * s,
                          static_cast<float>(v.y) * s,
                          static_cast<float>(v.z) * s,
                          static_cast<float>(v.w) * s);
    }
    done = n4 * 4;
  }
  for (long long i = done + t; i < n; i += stride)
    x[i] = static_cast<float>(q[i]) * s;
}

// CTAs for `items` work items at `per_cta` each: at least 1, at most 8 per
// SM (8 resident CTAs of 256 threads fill one).
int ctas(long long items, long long per_cta, int sms) {
  long long c = (items + per_cta - 1) / per_cta;
  const long long cap = 8LL * sms;
  if (c > cap) c = cap;
  return static_cast<int>(c < 1 ? 1 : c);
}

}  // namespace

extern "C" {

// x: n fp32; part: (chunks,) scratch, unused when chunks == 1; out: (1,).
// chunks comes from the wrapper, which sizes the scratch.
int absmax_f32(const float* x, float* part, float* out, long long n,
               int chunks, int vec, int sms, void* stream) {
  (void)sms;
  if (chunks > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    absmax_partial_kernel<<<chunks, kThreads, 0, s>>>(
        x, chunks == 1 ? out : part, n, vec);
    if (chunks > 1) absmax_finish_kernel<<<1, kThreads, 0, s>>>(part, out, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: n fp32; amax: (1,) fp32 on the device; q: n int8; scale: (1,) fp32.
int quantize_f32(const float* x, const float* amax, signed char* q,
                 float* scale, long long n, int vec, int sms, void* stream) {
  const int grid = ctas(n, 4LL * kThreads, sms);
  quant_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, amax, q, scale, n, vec);
  return static_cast<int>(cudaGetLastError());
}

// q: n int8; scale: (1,) fp32 on the device; x: n fp32.
int dequantize_f32(const signed char* q, const float* scale, float* x,
                   long long n, int vec, int sms, void* stream) {
  if (n > 0) {
    const int grid = ctas(n, 4LL * kThreads, sms);
    dequant_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        q, scale, x, n, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
