// Hopper (sm_90a) kernels of per-tensor int8 quantization: one tensor read
// as its n contiguous fp32 elements with a guarded tail (no padding to the
// reference's (R, 128) TPU tiling), one fp32 scale for the whole tensor.
// Times below: NVIDIA H100 80GB HBM3, power limit 700 W, device time of one
// call at the largest leaf of tinygpt-15m (the tied embedding, n =
// 12,865,792), median of 30; bounds at the H100 SXM's 3.35 TB/s.
//
// absmax         replaces src/repro/kernels/quantize.py:absmax (Pallas
//                 _absmax_kernel): max|x| over the tensor -> one fp32 value.
//                 NaN propagates, as in jnp.max. The reference reduces each
//                 (rows, 128) tile in the kernel and the tiles' maxima with
//                 jnp.max outside it.
//   Bound: bytes. One read of x: 51.5 MB, 0.0154 ms; one compare per
//   element. CTAs run in no order, so the reduction is two passes in one C
//   call, as leaf.cu's block_stats: pass 1 has C CTAs (up to 8 per SM),
//   each thread strides over the tensor four float4 loads at a time and a
//   shuffle tree plus one shared-memory round reduce the CTA to its
//   partial; pass 2, one CTA, reduces the C partials. A max is exact in any
//   order, so the result does not depend on C. With C = 1 pass 1 writes
//   the result and pass 2 is not launched.
//
// quantize_2d    replaces src/repro/kernels/quantize.py:quantize_2d (Pallas
//                 _quant_kernel and the scale around it): scale =
//                 max(absmax, 1e-12) / 127 and q = clip(rint(x / scale),
//                 -127, 127) as int8. Every thread computes the scale from
//                 the absmax on the device (no host synchronisation) with
//                 the reference's NaN rule (jnp.maximum propagates NaN);
//                 CTA 0 writes it out. A NaN quotient stores 0, as XLA's and
//                 PyTorch's float -> int8 conversions do.
//   Bound: bytes. 4 + 1 bytes per element: 64.3 MB, 0.0192 ms.
//
// dequantize_2d  replaces src/repro/kernels/quantize.py:dequantize_2d
//                 (Pallas _dequant_kernel): x = q * scale in fp32.
//   Bound: bytes. 1 + 4 bytes per element, as quantize_2d.
//
// The two int8 sweeps stream 16-byte accesses: a lane takes 16 elements
// (one int4 of q, four float4 of x) a trip, a warp's every load and store
// one contiguous 512-byte run (the int8 side passes through 512 bytes of
// shared memory a warp), and the grid walks the tensor in whole waves, so
// that the accesses in flight fall in one window that moves through x and
// q. Quantize rounds x * (1/s), the reciprocal rounded once a launch, and
// leaves the IEEE division to the quotients next to a half-integer (the
// only ones where the two can round apart: rint_quotient); it stores q
// with the default policy, so that q stays in L2 for the dequantize that
// follows on the path. Timed as in a stream of calls, each reading its
// input from memory (chip_smoke.py --only int8): quantize 0.0251-0.0252
// ms (76 % of its bound; one float4 a thread a trip took 0.0305),
// dequantize 0.0279-0.0281 (68 %; 0.0293), the pair 0.0446-0.0447
// against torch.fake_quantize_per_tensor_affine's 0.0520-0.0525. The
// card's own copy of x there moves 103 MB in 0.0419 ms (2.46 TB/s), at
// which the 64.3 MB of either sweep would take 0.0261. A route of bulk
// copies through a shared-memory ring (cp.async.bulk, an mbarrier a
// stage, bulk stores) took 0.0301 and 0.0291; asking L2 for q ahead of
// the dequantize's loads took nothing off.
//
// q is IEEE-rounded x / scale (in the body through the rule above, on the
// tail with __fdiv_rn) with rounding half to even (rintf), and the source
// is built with --fmad=false: q and the scale equal the plain PyTorch
// versions' bit for bit, and the dequantized values too (one product
// each). The body runs when the wrapper passes units > 0 (x and q 16-byte
// aligned); the tail and unaligned tensors go element by element.
//
// C interface for ctypes; every entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
// elements a lane takes per trip of the int8 sweeps' body
constexpr int kUnit = 16;
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

// clip(k, -127, 127) as int8, a NaN giving 0
__device__ __forceinline__ signed char to_int8(float k) {
  const float c = k != k ? 0.0f : fminf(fmaxf(k, -127.0f), 127.0f);
  return static_cast<signed char>(__float2int_rn(c));
}

__device__ __forceinline__ signed char quant_one(float x, float s) {
  return to_int8(rintf(__fdiv_rn(x, s)));
}

// rint(x / s), the quotient IEEE-rounded, from q0 = x * r with r = 1 / s
// rounded to nearest: two roundings put q0 within about 2 * 2^-24 * |q| of
// the exact quotient, and the IEEE quotient within 2^-24 * |q| of it, so
// within 3 * 2^-24 * |q| of each other. Unless q0 is within |q0| * 2^-21
// (4-8 ulp of q0) of a half-integer both round to the same integer; there,
// and only there, the IEEE division decides. A NaN or an infinite q0
// skips the test and matches the division's. tests/test_torch_quantize.py
// holds this rule to the division in numpy float32.
__device__ __forceinline__ float rint_quotient(float x, float s, float r) {
  const float q0 = x * r;
  const float k = rintf(q0);
  if (fabsf(fabsf(q0 - k) - 0.5f) <= fabsf(q0) * 0x1p-21f)
    return rintf(__fdiv_rn(x, s));
  return k;
}

// Four quantized elements as one little-endian 32-bit word.
__device__ __forceinline__ unsigned quant_word(float4 v, float s, float r) {
  return static_cast<unsigned char>(to_int8(rint_quotient(v.x, s, r)))
       | static_cast<unsigned>(static_cast<unsigned char>(
             to_int8(rint_quotient(v.y, s, r)))) << 8
       | static_cast<unsigned>(static_cast<unsigned char>(
             to_int8(rint_quotient(v.z, s, r)))) << 16
       | static_cast<unsigned>(static_cast<unsigned char>(
             to_int8(rint_quotient(v.w, s, r)))) << 24;
}

__device__ __forceinline__ float dequant_one(unsigned w, int byte, float s) {
  return static_cast<float>(static_cast<signed char>(w >> (8 * byte))) * s;
}

__device__ __forceinline__ float4 dequant_word(unsigned w, float s) {
  return make_float4(dequant_one(w, 0, s), dequant_one(w, 1, s),
                     dequant_one(w, 2, s), dequant_one(w, 3, s));
}

// The body, a grid-stride walk of whole waves: in trip t CTA b takes the
// 16-element units [(t * grid + b) * 256, ... + 256), its warp w the 32 of
// them from 32 w on (a unit is four float4 of x and one int4 of q, so a
// warp's trip is 2 KB of x and 512 bytes of q). The grid's accesses of a
// trip fall in one window of x and q that moves through them trip by trip.
// Lane l loads the warp's float4 l, l + 32, l + 64 and l + 96, each load
// one contiguous 512-byte run across the warp, and quantizes them to four
// int8 words; the words pass through the warp's 512 bytes of shared memory,
// so that lane l then stores unit l's 16 bytes as one int4, and the warp's
// store is one 512-byte run too. x is read with evict-first loads; q is
// stored with the default policy, so that it stays in L2 for the
// dequantize that reads it next. Then the n - 16 * units elements after
// the body (all n when units = 0: x or q not 16-byte aligned), one by one
// over every thread of the grid, with the IEEE division.
__global__ void __launch_bounds__(kThreads)
quant_kernel(const float* __restrict__ x, const float* __restrict__ amax,
             signed char* __restrict__ q, float* __restrict__ scale,
             long long n, long long units) {
  __shared__ int4 sh[kWarps][32];
  const float s = scale_of(amax[0]);
  if (blockIdx.x == 0 && threadIdx.x == 0) scale[0] = s;
  const float r = __frcp_rn(s);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  int4* q16 = reinterpret_cast<int4*>(q);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned* words = reinterpret_cast<unsigned*>(sh[warp]);
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long ub = static_cast<long long>(blockIdx.x) * kThreads + 32 * warp;
       ub < units; ub += step) {
    float4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long f = 4 * ub + lane + 32 * k;
      v[k] = f < 4 * units ? __ldcs(x4 + f) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) words[lane + 32 * k] = quant_word(v[k], s, r);
    __syncwarp();
    const int4 w = sh[warp][lane];
    if (ub + lane < units) q16[ub + lane] = w;
    __syncwarp();
  }
  for (long long i = units * kUnit + blockIdx.x * kThreads + threadIdx.x;
       i < n; i += step)
    q[i] = quant_one(x[i], s);
}

// As quant_kernel, the other way: lane l loads unit l's int4 of q, and
// after the pass through shared memory dequantizes and stores the warp's
// float4 l, l + 32, l + 64 and l + 96; it loads its next trip's q before
// it stores this one's x. q is loaded with the default policy (on the
// path it is in L2, where quantize_2d left it); x is stored evict-first.
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const signed char* __restrict__ q,
               const float* __restrict__ scale, float* __restrict__ x,
               long long n, long long units) {
  __shared__ int4 sh[kWarps][32];
  const float s = scale[0];
  const int4* q16 = reinterpret_cast<const int4*>(q);
  float4* x4 = reinterpret_cast<float4*>(x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned* words = reinterpret_cast<const unsigned*>(sh[warp]);
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  long long ub = static_cast<long long>(blockIdx.x) * kThreads + 32 * warp;
  int4 w = ub + lane < units ? q16[ub + lane] : make_int4(0, 0, 0, 0);
  for (; ub < units; ub += step) {
    const int4 next =
        ub + step + lane < units ? q16[ub + step + lane] : make_int4(0, 0, 0, 0);
    sh[warp][lane] = w;
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long f = 4 * ub + lane + 32 * k;
      const float4 o = dequant_word(words[lane + 32 * k], s);
      if (f < 4 * units) __stcs(x4 + f, o);
    }
    __syncwarp();
    w = next;
  }
  for (long long i = units * kUnit + blockIdx.x * kThreads + threadIdx.x;
       i < n; i += step)
    x[i] = static_cast<float>(q[i]) * s;
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

// The resident CTAs of kThreads threads one SM holds of each sweep; the
// wrapper sizes the grid (one wave) from them.
int quantize_ctas_per_sm(int* quant, int* dequant) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      quant, quant_kernel, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        dequant, dequant_kernel, kThreads, 0);
  return static_cast<int>(err);
}

// x: n fp32; amax: (1,) fp32 on the device; q: n int8; scale: (1,) fp32.
// units: 16-element units of the body (x and q 16-byte aligned), walked by
// grid CTAs; both come from the wrapper (kernels/quantize.py:plan).
int quantize_f32(const float* x, const float* amax, signed char* q,
                 float* scale, long long n, long long units, int grid,
                 int sms, void* stream) {
  (void)sms;
  quant_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, amax, q, scale, n, units);
  return static_cast<int>(cudaGetLastError());
}

// q: n int8; scale: (1,) fp32 on the device; x: n fp32; units and grid as
// for quantize_f32.
int dequantize_f32(const signed char* q, const float* scale, float* x,
                   long long n, long long units, int grid, int sms,
                   void* stream) {
  (void)sms;
  if (n > 0)
    dequant_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        q, scale, x, n, units);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
