// Threefry-2x32 draws: jax.random.uniform and jax.random.normal on the card.
//
// Replaces no Pallas kernel. The JAX train step draws its augmentation and
// SGM noise with jax.random (threefry-2x32, the partitionable layout), which
// XLA fuses into the jitted step as one pass; the port's plain version
// (utils/jrandom.py) runs the 20 rounds as ~130 eager int32 passes over each
// array, and the float steps' fused multiply-adds in float64. This kernel
// makes one array in one pass, and equals the plain version bit for bit:
//
//   j = offset + (i / run) * stride + i % run         (flat index of item i)
//   (y0, y1) = threefry2x32(key, (j >> 32, j & 0xFFFFFFFF)),  b = y0 ^ y1
//   uniform:  max(lo, fma(float(b >> 9 | 0x3F800000) - 1, scale, lo))
//   normal:   sqrt(2) * erf_inv(uniform with lo = nextafter(-1, 0), hi = 1)
//
// with erf_inv XLA's single-precision polynomial and XLA's log1p (a
// rational function below sqrt(2) - 1, Cephes' log above), each a * b + c
// of their polynomials a fused multiply-add as XLA's CPU compiler emits it.
// Every other operation is written with a round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn), which nvcc never contracts into an FMA, so the
// card rounds where the plain version does. bf16 output takes jax's 16-bit
// path: 8 random bits (b & 0xFF) >> 1 under bf16's exponent of 1.0, each
// bf16 operation rounded to bf16, erf_inv in float32.
//
// (run, stride, offset) pick a data-parallel rank's frames of a global draw
// (run = count, offset = 0: the whole array).
//
// What bounds it on the H100: integer operations. A value costs one
// threefry block and writes 4 bytes. nvcc compiles the block to 68
// instructions: 54 on the integer ALU pipe (20 funnel shifts, 21 xors, 13
// three-input adds that fold the key injections) and 14 adds as IMAD on
// the FMA pipe; 28.3 M values (the SF step's draws) are 1.53 G ALU
// operations (0.091 ms at 64 lanes an SM) against 113 MB written
// (0.03 ms). One
// thread computes one block and writes its value; the key words are kernel
// arguments (constant bank), the counters come from the thread index,
// nothing is read from memory, and the whole-array case skips the 64-bit
// division of the index map.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, kRot[i % 2][r]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// XLA's float32 log on the CPU (Cephes), for positive normal x.
__device__ __forceinline__ float xla_log(float v) {
  int ei;
  float m = frexpf(v, &ei);
  float e = static_cast<float>(ei);
  const bool small = m < 0.707106781186547524f;
  float x = __fadd_rn(__fsub_rn(m, 1.0f), small ? m : 0.0f);
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  const float x2 = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x2, x);
  float y = __fmaf_rn(x, 7.0376836292E-2f, -1.1514610310E-1f);
  float y1 = __fmaf_rn(x, -1.2420140846E-1f, 1.4249322787E-1f);
  float y2 = __fmaf_rn(x, 2.0000714765E-1f, -2.4999993993E-1f);
  y = __fmaf_rn(y, x, 1.1676998740E-1f);
  y1 = __fmaf_rn(y1, x, -1.6668057665E-1f);
  y2 = __fmaf_rn(y2, x, 3.3333331174E-1f);
  y = __fmaf_rn(y, x3, y1);
  y = __fmaf_rn(y, x3, y2);
  y = __fmaf_rn(y, x3, __fmul_rn(-2.12194440e-4f, e));
  x = __fsub_rn(x, __fmul_rn(0.5f, x2));
  x = __fadd_rn(x, y);
  return __fmaf_rn(e, 0.693359375f, x);
}

// XLA's float32 log1p, for x in (-1, 0].
__device__ __forceinline__ float xla_log1p(float x) {
  if (fabsf(x) >= 0.41421356237309504880f) return xla_log(__fadd_rn(x, 1.0f));
  constexpr float kNum[7] = {
      4.5270000862445199635215E-5f, 4.9854102823193375972212E-1f,
      6.5787325942061044846969E0f,  2.9911919328553073277375E1f,
      6.0949667980987787057556E1f,  5.7112963590585538103336E1f,
      2.0039553499201281259648E1f};
  constexpr float kDen[7] = {
      1.f,
      1.5062909083469192043167E1f, 8.3047565967967209469434E1f,
      2.2176239823732856465394E2f, 3.0909872225312059774938E2f,
      2.1642788614495947685003E2f, 6.0118660497603843919306E1f};
  float num = kNum[0], den = kDen[0];
#pragma unroll
  for (int i = 1; i < 7; ++i) {
    num = __fmaf_rn(num, x, kNum[i]);
    den = __fmaf_rn(den, x, kDen[i]);
  }
  const float x2 = __fmul_rn(x, x);
  float s = __fdiv_rn(num, den);
  s = __fmul_rn(__fmul_rn(x, x2), s);
  s = __fmaf_rn(x2, -0.5f, s);
  return __fadd_rn(x, s);
}

// XLA's float32 ErfInv (Giles), for x in [-1, 1].
__device__ __forceinline__ float xla_erf_inv(float x) {
  constexpr float kLt5[9] = {2.81022636e-08f,  3.43273939e-07f,
                             -3.5233877e-06f,  -4.39150654e-06f,
                             0.00021858087f,   -0.00125372503f,
                             -0.00417768164f,  0.246640727f,
                             1.50140941f};
  constexpr float kGe5[9] = {-0.000200214257f, 0.000100950558f,
                             0.00134934322f,   -0.00367342844f,
                             0.00573950773f,   -0.0076224613f,
                             0.00943887047f,   1.00167406f,
                             2.83297682f};
  float w = -xla_log1p(-__fmul_rn(x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? kLt5[0] : kGe5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, w, lt ? kLt5[i] : kGe5[i]);
  const float out = __fmul_rn(p, x);
  return fabsf(x) == 1.0f ? __fmul_rn(x, 3.402823466e+38f) : out;
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// transform: 0 uniform, 1 normal, 2 the raw 32 bits (out is uint32)
template <bool BF16>
__global__ void threefry_draw_kernel(void* __restrict__ out, long long count,
                                     uint32_t k0, uint32_t k1, long long run,
                                     long long stride, long long offset,
                                     int transform, float lo, float scale,
                                     float sqrt2) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < count; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    // the whole array (run >= count) needs no 64-bit division
    const unsigned long long j = static_cast<unsigned long long>(
        run >= count ? offset + i : offset + (i / run) * stride + i % run);
    uint32_t x0 = static_cast<uint32_t>(j >> 32);
    uint32_t x1 = static_cast<uint32_t>(j);
    threefry2x32(k0, k1, x0, x1);
    const uint32_t b = x0 ^ x1;
    float v;
    if (transform == 2) {
      static_cast<uint32_t*>(out)[i] = b;
    } else if (!BF16) {
      const float f = __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
      v = fmaxf(lo, __fmaf_rn(f, scale, lo));
      if (transform == 1) v = __fmul_rn(sqrt2, xla_erf_inv(v));
      static_cast<float*>(out)[i] = v;
    } else {
      const uint32_t h = ((b & 0xFFu) >> 1) | 0x3F80u;
      const float f = __fsub_rn(__uint_as_float(h << 16), 1.0f);
      v = fmaxf(lo, bf16r(__fadd_rn(bf16r(__fmul_rn(f, scale)), lo)));
      if (transform == 1) v = bf16r(__fmul_rn(sqrt2, bf16r(xla_erf_inv(v))));
      static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
    }
  }
}

}  // namespace

// out: count float32 (bf16 = 0) or bfloat16 (bf16 = 1) values, or uint32
// bits (transform 2). lo, scale:
// the uniform's minval and (maxval - minval), rounded to the output type;
// sqrt2: sqrt(2) in the output type.
extern "C" int dis_threefry_draw(void* out, long long count, unsigned k0,
                                 unsigned k1, long long run, long long stride,
                                 long long offset, int transform, int bf16,
                                 float lo, float scale, float sqrt2,
                                 void* stream) {
  const int threads = 256;
  const long long want = (count + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 1048576 ? want : 1048576);
  if (bf16)
    threefry_draw_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        out, count, k0, k1, run, stride, offset, transform, lo, scale, sqrt2);
  else
    threefry_draw_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        out, count, k0, k1, run, stride, offset, transform, lo, scale, sqrt2);
  return (int)cudaGetLastError();
}
