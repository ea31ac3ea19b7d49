// Pair-indexed bilinear flow warp with zeros padding, forward and backward
// (kernel K4), for float32 and bfloat16 features.
//
// Replaces: depthinspace_tpu/ops/pallas/warp2d_pairs.py::_pairs_fwd and
// ::_pairs_bwd (the Pallas bodies _fwd_kernel and _bwd_kernel), reached
// through warp2d_pairs from ops/resample.py::flow_warp_pairs. FuseNet's
// fusion blocks warp the same S = tl*N feature planes along the M =
// tl*(tl-1)*N (target, source) pairs of a track.
//
//   out[m](p) = feat[src[m]](p + flow[m](p)), bilinear; each of the four
//   corners whose integer index lies outside the image contributes 0.
//
// The forward computes K3's function (csrc/warp2d.cu) with the corners taken
// from plane src[m] of feat, so the pair-major stack of sources is never
// built. The corner weights, the per-corner validity and the clamp before
// the int conversion are K3's (taps() below), and each channel sums
// v00*w00 + v01*w01 + v10*w10 + v11*w11 in that order with round-to-nearest
// intrinsics, so the forward is bit-exact to the plain version in both
// types. bfloat16 features are widened exactly to float32, weighted and
// summed in float32 and rounded once at the store, as the TPU kernel DMAs
// bf16, accumulates in f32 and casts at the end. Unbounded like the CPU
// truth (ops/sampling.py::warp): no offset beyond +-19 px is dropped. The
// TPU kernel's band windows, offset enumeration and scalar-prefetched range
// tables existed because gathers were slow there.
//
// What bounds the forward on the H100: memory, once the instructions per
// output byte are few. Per output pixel it reads one flow float2 and four
// data-dependent corners of C channels (C = 32 bf16: 64 contiguous bytes a
// corner) and writes C channels. The first design, one thread per (pixel,
// channel) element, spent ~30 instructions of taps and index arithmetic and
// four 2-byte loads on each 2-byte output, and ran as fast in f32 as in
// bf16: instructions and latency bound it, at 11 % of its byte bound. The
// vector kernel does three things about that:
//   - a thread owns VPT 16-byte vectors of one pixel's channels (8 bf16 or
//     4 float32 each); it loads the flow as one float2, computes the taps
//     once, makes one 16-byte read-only (__ldg, ld.global.nc) load per
//     valid corner and vector, all in flight before any arithmetic, and one
//     16-byte store a vector. Neighbouring pixels share corners, which L1
//     serves. The wrapper takes VPT = 2 where C allows it (else 1): at
//     C = 32 it was faster than one vector a thread and than a whole pixel
//     a thread (4 or 8 vectors) in both types;
//   - a block is (C / (8 or 4) / VPT threads of a pixel) x (pixels), over
//     a pair's whole plane, so no row leaves a ragged block;
//   - the grid's pair axis walks `order`, the pairs grouped by source: the
//     pairs that read one source plane (3.5 MB at 256x216x32 bf16) run back
//     to back while it sits in the 50 MB L2, instead of 12 pairs apart in
//     the table's target-major order. Each output is still written at its
//     own slot m, so the result does not depend on the order.
// It needs C a multiple of the vector's channels and 16-byte aligned feat
// and out (8-byte aligned flow); the wrapper checks that and otherwise
// launches the scalar kernel, the first design, one thread per element.
// Not the tools here: TMA, cp.async staging and shared memory. The corners
// depend on the data and the flow has no bound, so no tile with a halo is
// known ahead (a 32-channel halo of +-16 px would not fit in shared memory
// either); nothing is a matrix product, so tensor cores do not apply.
//
// The backward scatters w*g to the four valid corners of plane src[m] with
// float atomics into a float32 (S, H, W, C) scratch that the launcher
// zeroes on the stream; for bfloat16 a cast kernel then rounds the scratch
// into the bf16 gradient, as the TPU kernel casts its f32 grad_pad. The
// atomics make the bits of a sum of three or more contributions vary from
// run to run. The TPU kernel's grid needed every source in the same number
// of pairs; this one takes any table with 0 <= src[m] < S (the wrapper
// checks it on the host).
//
// What bounds the backward on the H100: the atomics in L2. At the DIS-MF
// shapes (S = 16, M = 48, C = 32, 256x216 + 128x108) one thread per
// element (the first design, kept as the scalar path) makes ~425 M scalar
// f32 atomics; each warp covers one corner's 32 channels, so its atomics
// reach L2 as one 128-byte request, and bf16 (0.96 ms) ran slower than
// f32 (0.87 ms) at 10-20 % of the byte bound. 16-byte vectors of g (8 bf16
// or 4 f32 channels) a thread, each added with float4 atomics at the
// thread's own channels, were slower still in bf16 (1.24 ms): a warp's
// atomic then touched 16-byte pieces of 8 or 16 lines. The vector scatter:
//   - a thread owns 4-channel vectors of g (one 16-byte float32 or 8-byte
//     bfloat16 load), and the G = C / 4 threads of a pixel hold its
//     channels in order, so each 16-byte vector atomic (sm_90, global
//     memory) of the G threads covers a corner's whole 128-byte line at
//     C = 32, and a warp's covers 4 pixels' corners;
//   - a thread takes PX = 8 consecutive pixels of a row and sums in
//     registers the corners that a pixel shares with its left neighbour
//     (the same integer corner column, the usual case for a smooth flow),
//     so PX pixels take 2*PX + 2 corner atomics instead of 4*PX;
//   - the grid's pair axis walks the source-major `order`, so the 3 pairs
//     that scatter into one 7 MB float32 plane run back to back while it
//     sits in L2.
// Taps and products stay those of the scalar kernel (w * g rounded to
// nearest a channel). The scatter still takes ~80 % of the bf16 call; the
// zeroing and the cast move 141 MB and 212 MB near the HBM rate. Two
// vectors a thread (8-11 % slower) and 1, 2 or 4 pixels a thread (slower
// the fewer) lost; they are built only with -DDIS_AB_VARIANTS, with an
// entry point that runs one part of the call alone, for
// scripts/ab_torch_kernels.py and chip_smoke.py to time. The wrapper takes
// the scalar path for C not a multiple of 4, unaligned g or flow
// (kernels.pairs_bwd_path).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The bilinear taps of pixel (u, v) of flow plane m: weights, corners and
// their validity, exactly as warp2d.cu computes them.
struct Taps {
  float w00, w01, w10, w11;
  int x0, y0, x1, y1;
  bool vx0, vx1, vy0, vy1;
};

__device__ __forceinline__ Taps taps_at(float fx, float fy, int u, int v,
                                        int H, int W) {
  Taps t;
  const float gx = __fadd_rn(fx, (float)u);
  const float gy = __fadd_rn(fy, (float)v);
  const float x0f = floorf(gx);
  const float y0f = floorf(gy);
  const float wx1 = __fsub_rn(gx, x0f);
  const float wy1 = __fsub_rn(gy, y0f);
  const float wx0 = __fsub_rn(1.0f, wx1);
  const float wy0 = __fsub_rn(1.0f, wy1);
  t.w00 = __fmul_rn(wy0, wx0);
  t.w01 = __fmul_rn(wy0, wx1);
  t.w10 = __fmul_rn(wy1, wx0);
  t.w11 = __fmul_rn(wy1, wx1);
  // clamp before the integer conversion so a huge or NaN coordinate cannot
  // overflow; every clamped value stays outside the image, as it was
  t.x0 = (int)fminf(fmaxf(x0f, -2.0f), (float)(W + 1));
  t.y0 = (int)fminf(fmaxf(y0f, -2.0f), (float)(H + 1));
  t.x1 = t.x0 + 1;
  t.y1 = t.y0 + 1;
  t.vx0 = t.x0 >= 0 && t.x0 <= W - 1;
  t.vx1 = t.x1 >= 0 && t.x1 <= W - 1;
  t.vy0 = t.y0 >= 0 && t.y0 <= H - 1;
  t.vy1 = t.y1 >= 0 && t.y1 <= H - 1;
  return t;
}

__device__ __forceinline__ Taps taps(const float* __restrict__ flow,
                                     long long p, int u, int v, int H,
                                     int W) {
  return taps_at(flow[2 * p], flow[2 * p + 1], u, v, H, W);
}

// The thread's output element on a grid of (chunks of a row's W*C
// elements, rows, pairs): channel c of pixel p = (m, v, u). Only the
// position within the row needs a division, in 32 bits.
struct Element {
  long long p, m;
  int u, v, c;
};

__device__ __forceinline__ bool element(int H, int W, int C, Element& x) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= W * C) return false;
  x.u = e / C;
  x.c = e - x.u * C;
  x.v = blockIdx.y;
  x.m = blockIdx.z;
  x.p = (x.m * H + x.v) * W + x.u;
  return true;
}

template <typename T>
__global__ void warp2d_pairs_fwd_kernel(const T* __restrict__ feat,
                                        const float* __restrict__ flow,
                                        const int* __restrict__ src,
                                        T* __restrict__ out, int H, int W,
                                        int C) {
  Element x;
  if (!element(H, W, C, x)) return;
  const Taps t = taps(flow, x.p, x.u, x.v, H, W);

  const int cx0 = min(max(t.x0, 0), W - 1);
  const int cx1 = min(max(t.x1, 0), W - 1);
  const int cy0 = min(max(t.y0, 0), H - 1);
  const int cy1 = min(max(t.y1, 0), H - 1);
  const T* base = feat + (long long)src[x.m] * H * (long long)W * C + x.c;
  const float v00 = (t.vy0 && t.vx0)
                        ? load_f32(base + ((long long)cy0 * W + cx0) * C)
                        : 0.0f;
  const float v01 = (t.vy0 && t.vx1)
                        ? load_f32(base + ((long long)cy0 * W + cx1) * C)
                        : 0.0f;
  const float v10 = (t.vy1 && t.vx0)
                        ? load_f32(base + ((long long)cy1 * W + cx0) * C)
                        : 0.0f;
  const float v11 = (t.vy1 && t.vx1)
                        ? load_f32(base + ((long long)cy1 * W + cx1) * C)
                        : 0.0f;
  float acc = __fmul_rn(v00, t.w00);
  acc = __fadd_rn(acc, __fmul_rn(v01, t.w01));
  acc = __fadd_rn(acc, __fmul_rn(v10, t.w10));
  store_f32(out + x.p * C + x.c, __fadd_rn(acc, __fmul_rn(v11, t.w11)));
}

// A 16-byte vector of channels: its raw type, its channels as float32 (the
// bfloat16 ones widened exactly: the bits shifted up), and the store with
// one round-to-nearest rounding a channel.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  using Raw = float4;
  static constexpr int kN = 4;
  __device__ static void widen(const float4& r, float (&f)[kN]) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
  __device__ static void store(float* p, const float (&f)[kN]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  using Raw = uint4;
  static constexpr int kN = 8;
  __device__ static void widen(const uint4& r, float (&f)[kN]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);  // the lower address
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static unsigned pack(float lo, float hi) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
  __device__ static void store(__nv_bfloat16* p, const float (&f)[kN]) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]),
                   pack(f[6], f[7]));
  }
};

template <typename Raw>
__device__ __forceinline__ Raw load_nc(const void* p, bool valid) {
  Raw r{};
  if (valid) r = __ldg(reinterpret_cast<const Raw*>(p));
  return r;
}

// The vector forward: block (G, P) is G threads on each of P pixels of a
// plane, G = C / (Vec::kN * VPT); thread x owns channels [x*VPT*kN,
// (x+1)*VPT*kN) of its pixel. blockIdx.y walks the source-major order of
// the pairs.
template <typename T, int VPT>
__global__ void __launch_bounds__(256)
    warp2d_pairs_fwd_vec_kernel(const T* __restrict__ feat,
                                const float* __restrict__ flow,
                                const int* __restrict__ src,
                                const int* __restrict__ order,
                                T* __restrict__ out, int H, int W, int C) {
  using V = Vec<T>;
  using Raw = typename V::Raw;
  constexpr int kN = V::kN;
  const int pix = blockIdx.x * blockDim.y + threadIdx.y;
  if (pix >= H * W) return;
  const int v = pix / W;
  const int u = pix - v * W;
  const long long m = order[blockIdx.y];
  const long long p = m * H * W + pix;
  const float2 f = __ldg(reinterpret_cast<const float2*>(flow) + p);
  const Taps t = taps_at(f.x, f.y, u, v, H, W);

  const int cx0 = min(max(t.x0, 0), W - 1);
  const int cx1 = min(max(t.x1, 0), W - 1);
  const int cy0 = min(max(t.y0, 0), H - 1);
  const int cy1 = min(max(t.y1, 0), H - 1);
  const int c0 = threadIdx.x * VPT * kN;
  const T* base = feat + (long long)src[m] * H * (long long)W * C + c0;
  const T* corner[4] = {base + ((long long)cy0 * W + cx0) * C,
                        base + ((long long)cy0 * W + cx1) * C,
                        base + ((long long)cy1 * W + cx0) * C,
                        base + ((long long)cy1 * W + cx1) * C};
  const bool valid[4] = {t.vy0 && t.vx0, t.vy0 && t.vx1, t.vy1 && t.vx0,
                         t.vy1 && t.vx1};
  const float w[4] = {t.w00, t.w01, t.w10, t.w11};

  // every load in flight before the first product
  Raw raw[VPT][4];
#pragma unroll
  for (int k = 0; k < VPT; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      raw[k][q] = load_nc<Raw>(corner[q] + k * kN, valid[q]);

  T* o = out + p * C + c0;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    float val[4][kN], acc[kN];
#pragma unroll
    for (int q = 0; q < 4; ++q) V::widen(raw[k][q], val[q]);
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      float a = __fmul_rn(val[0][c], w[0]);
      a = __fadd_rn(a, __fmul_rn(val[1][c], w[1]));
      a = __fadd_rn(a, __fmul_rn(val[2][c], w[2]));
      acc[c] = __fadd_rn(a, __fmul_rn(val[3][c], w[3]));
    }
    V::store(o + k * kN, acc);
  }
}

template <typename T>
__global__ void warp2d_pairs_bwd_kernel(const float* __restrict__ flow,
                                        const int* __restrict__ src,
                                        const T* __restrict__ g,
                                        float* __restrict__ grad, int H,
                                        int W, int C) {
  Element x;
  if (!element(H, W, C, x)) return;
  const Taps t = taps(flow, x.p, x.u, x.v, H, W);

  float* base = grad + (long long)src[x.m] * H * (long long)W * C + x.c;
  const float gc = load_f32(g + x.p * C + x.c);
  if (t.vy0 && t.vx0)
    atomicAdd(base + ((long long)t.y0 * W + t.x0) * C, __fmul_rn(gc, t.w00));
  if (t.vy0 && t.vx1)
    atomicAdd(base + ((long long)t.y0 * W + t.x1) * C, __fmul_rn(gc, t.w01));
  if (t.vy1 && t.vx0)
    atomicAdd(base + ((long long)t.y1 * W + t.x0) * C, __fmul_rn(gc, t.w10));
  if (t.vy1 && t.vx1)
    atomicAdd(base + ((long long)t.y1 * W + t.x1) * C, __fmul_rn(gc, t.w11));
}

// Four channels of g, widened to float32: one 16-byte load in float32,
// one 8-byte load in bfloat16 (exact: the bits shifted up), both through
// the read-only path.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(r.x << 16),
                     __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16),
                     __uint_as_float(r.y & 0xffff0000u));
}

__device__ __forceinline__ float4 scale4(const float4& g, float w) {
  return make_float4(__fmul_rn(g.x, w), __fmul_rn(g.y, w), __fmul_rn(g.z, w),
                     __fmul_rn(g.w, w));
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// One column of a pixel's corners, (x, y) and (x, y + 1): their validity
// and their VPT vectors of w * g, added into the scratch with one 16-byte
// vector atomic (sm_90, global memory) each.
template <int VPT>
struct Column {
  int x, y;
  bool top, bottom;
  float4 t[VPT], b[VPT];

  __device__ void flush(float* plane, int W, int C, int G, int lane) const {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int c = 4 * (k * G + lane);
      if (top)
        atomicAdd(reinterpret_cast<float4*>(
                      plane + ((long long)y * W + x) * C + c), t[k]);
      if (bottom)
        atomicAdd(reinterpret_cast<float4*>(
                      plane + ((long long)(y + 1) * W + x) * C + c), b[k]);
    }
  }
};

// The vector scatter. Block (G, B): G threads on each of B groups of PX
// consecutive pixels of a pair's plane; G = C / (4 * VPT) and thread l of
// a group owns the 4-channel vectors k = 0..VPT-1 at channels
// 4 * (k * G + l), so the G threads of a pixel cover G * 16 contiguous
// bytes of a corner with each vector atomic (a whole 128-byte line at
// C = 32, VPT = 1), as the scalar kernel's warp covers one corner's 32
// channels. blockIdx.y walks the source-major order of the pairs, so the
// pairs that scatter into one source plane run back to back while it sits
// in L2. A thread loads its pixels' flows (float2) and g vectors first,
// then computes each pixel's taps once and its w * g with one
// round-to-nearest product a channel, as the scalar kernel. Where a
// pixel's left column of corners is the previous pixel's right column
// (the integer corner one to the right, the same row: the usual case for
// a smooth flow), the two are summed in registers and added once, so PX
// pixels in a row take 2 * PX + 2 corner atomics instead of 4 * PX.
template <typename T, int VPT, int PX>
__global__ void __launch_bounds__(256)
    warp2d_pairs_bwd_vec_kernel(const float* __restrict__ flow,
                                const int* __restrict__ src,
                                const int* __restrict__ order,
                                const T* __restrict__ g,
                                float* __restrict__ grad, int H, int W,
                                int C) {
  const int G = blockDim.x;
  const int lane = threadIdx.x;
  const int HW = H * W;
  const int pix0 = (blockIdx.x * blockDim.y + threadIdx.y) * PX;
  if (pix0 >= HW) return;
  const long long m = order[blockIdx.y];
  const long long p0 = m * HW + pix0;
  const int n = min(PX, HW - pix0);

  float2 f[PX];
  float4 gv[PX][VPT];
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    if (j >= n) break;
    f[j] = __ldg(reinterpret_cast<const float2*>(flow) + p0 + j);
#pragma unroll
    for (int k = 0; k < VPT; ++k)
      gv[j][k] = load4(g + (p0 + j) * C + 4 * (k * G + lane));
  }

  float* plane = grad + (long long)src[m] * HW * C;
  int v = pix0 / W;
  int u = pix0 - v * W;
  Column<VPT> carry;  // the previous pixel's right column, not yet added
#pragma unroll
  for (int j = 0; j < PX; ++j) {
    if (j >= n) break;
    const Taps t = taps_at(f[j].x, f[j].y, u, v, H, W);
    Column<VPT> left;
    left.x = t.x0;
    left.y = t.y0;
    left.top = t.vy0 && t.vx0;
    left.bottom = t.vy1 && t.vx0;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      left.t[k] = scale4(gv[j][k], t.w00);
      left.b[k] = scale4(gv[j][k], t.w10);
    }
    if (j > 0 && carry.x == left.x && carry.y == left.y) {
      // the same two corners (so the same validity): one sum, one add
#pragma unroll
      for (int k = 0; k < VPT; ++k) {
        left.t[k] = add4(carry.t[k], left.t[k]);
        left.b[k] = add4(carry.b[k], left.b[k]);
      }
    } else if (j > 0) {
      carry.flush(plane, W, C, G, lane);
    }
    left.flush(plane, W, C, G, lane);
    carry.x = t.x1;
    carry.y = t.y0;
    carry.top = t.vy0 && t.vx1;
    carry.bottom = t.vy1 && t.vx1;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      carry.t[k] = scale4(gv[j][k], t.w01);
      carry.b[k] = scale4(gv[j][k], t.w11);
    }
    if (++u == W) {
      u = 0;
      ++v;
    }
  }
  carry.flush(plane, W, C, G, lane);
}

// Rounds the float32 gradient into bfloat16: 4 elements an iteration (one
// 16-byte load, one 8-byte store), then the tail; x and y are the
// launcher's own allocations, 16- and 8-byte aligned.
__global__ void f32_to_bf16_kernel(const float* __restrict__ x,
                                   __nv_bfloat16* __restrict__ y,
                                   long long n) {
  using V = Vec<__nv_bfloat16>;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = n / 4;
  for (long long i = first; i < n4; i += stride) {
    const float4 a = reinterpret_cast<const float4*>(x)[i];
    reinterpret_cast<uint2*>(y)[i] =
        make_uint2(V::pack(a.x, a.y), V::pack(a.z, a.w));
  }
  for (long long i = 4 * n4 + first; i < n; i += stride)
    y[i] = __float2bfloat16_rn(x[i]);
}

constexpr int kThreads = 256;

inline dim3 grid_for(int M, int H, int W, int C) {
  return dim3((W * C + kThreads - 1) / kThreads, H, M);
}

template <typename T>
int fwd_scalar(const void* feat, const float* flow, const int* src, void* out,
               int M, int H, int W, int C, void* stream) {
  warp2d_pairs_fwd_kernel<T>
      <<<grid_for(M, H, W, C), kThreads, 0, (cudaStream_t)stream>>>(
          (const T*)feat, flow, src, (T*)out, H, W, C);
  return (int)cudaGetLastError();
}

template <typename T, int VPT>
int fwd_vec(const void* feat, const float* flow, const int* src,
            const int* order, void* out, int M, int H, int W, int C,
            void* stream) {
  const int G = C / (Vec<T>::kN * VPT);
  if (G < 1 || G > kThreads || G * Vec<T>::kN * VPT != C)
    return (int)cudaErrorInvalidValue;
  const dim3 block(G, kThreads / G);
  const dim3 grid((H * W + block.y - 1) / block.y, M);
  warp2d_pairs_fwd_vec_kernel<T, VPT>
      <<<grid, block, 0, (cudaStream_t)stream>>>(
          (const T*)feat, flow, src, order, (T*)out, H, W, C);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const void* feat, const float* flow, const int* src,
        const int* order, void* out, int M, int H, int W, int C, int vpt,
        void* stream) {
  switch (vpt) {
    case 0:
      return fwd_scalar<T>(feat, flow, src, out, M, H, W, C, stream);
    case 1:
      return fwd_vec<T, 1>(feat, flow, src, order, out, M, H, W, C, stream);
    case 2:
      return fwd_vec<T, 2>(feat, flow, src, order, out, M, H, W, C, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int VPT, int PX>
int bwd_vec(const float* flow, const int* src, const int* order,
            const void* g, float* scratch, int M, int H, int W, int C,
            cudaStream_t stream) {
  const int G = C / (4 * VPT);
  if (G < 1 || G > kThreads || G * 4 * VPT != C)
    return (int)cudaErrorInvalidValue;
  const dim3 block(G, kThreads / G);
  const int groups = (H * W + PX - 1) / PX;
  const dim3 grid((groups + block.y - 1) / block.y, M);
  warp2d_pairs_bwd_vec_kernel<T, VPT, PX><<<grid, block, 0, stream>>>(
      flow, src, order, (const T*)g, scratch, H, W, C);
  return (int)cudaGetLastError();
}

// The scatter alone, onto the scratch as it stands: vpt = 0 the scalar
// scatter, vpt = 1 the vector scatter (one 4-channel vector of 8 pixels a
// thread); with -DDIS_AB_VARIANTS also the variants that lost, vpt = 1 or
// 2 vectors of px = 1, 2, 4 or 8 pixels.
template <typename T>
int scatter(const float* flow, const int* src, const int* order,
            const void* g, float* scratch, int M, int H, int W, int C,
            int vpt, int px, cudaStream_t s) {
  if (vpt == 0) {
    warp2d_pairs_bwd_kernel<T><<<grid_for(M, H, W, C), kThreads, 0, s>>>(
        flow, src, (const T*)g, scratch, H, W, C);
    return (int)cudaGetLastError();
  }
  if (vpt == 1 && px == 8)
    return bwd_vec<T, 1, 8>(flow, src, order, g, scratch, M, H, W, C, s);
#ifdef DIS_AB_VARIANTS
  switch (10 * vpt + px) {
    case 11:
      return bwd_vec<T, 1, 1>(flow, src, order, g, scratch, M, H, W,
                              C, s);
    case 12:
      return bwd_vec<T, 1, 2>(flow, src, order, g, scratch, M, H, W,
                              C, s);
    case 14:
      return bwd_vec<T, 1, 4>(flow, src, order, g, scratch, M, H, W,
                              C, s);
    case 21:
      return bwd_vec<T, 2, 1>(flow, src, order, g, scratch, M, H, W,
                              C, s);
    case 22:
      return bwd_vec<T, 2, 2>(flow, src, order, g, scratch, M, H, W,
                              C, s);
    case 24:
      return bwd_vec<T, 2, 4>(flow, src, order, g, scratch, M, H, W,
                              C, s);
    case 28:
      return bwd_vec<T, 2, 8>(flow, src, order, g, scratch, M, H, W,
                              C, s);
  }
#endif
  return (int)cudaErrorInvalidValue;
}

int zero(float* scratch, long long n, cudaStream_t s) {
  return (int)cudaMemsetAsync(scratch, 0, sizeof(float) * (size_t)n, s);
}

// Rounds the n floats of scratch into grad (bfloat16).
int cast(const float* scratch, void* grad, long long n, cudaStream_t s) {
  const int threads = 256;
  const long long want = n / 4 / threads + 1;
  const int blocks = (int)(want < 132 * 32 ? want : 132 * 32);
  if (n > 0)
    f32_to_bf16_kernel<<<blocks, threads, 0, s>>>(
        scratch, (__nv_bfloat16*)grad, n);
  return (int)cudaGetLastError();
}

int bwd(const float* flow, const int* src, const int* order, const void* g,
        float* scratch, void* grad_bf16, int S, int M, int H, int W, int C,
        int bf16, int vpt, int px, cudaStream_t s) {
  const long long n = (long long)S * H * W * C;
  int err = zero(scratch, n, s);
  if (err == 0)
    err = bf16 ? scatter<__nv_bfloat16>(flow, src, order, g, scratch, M, H,
                                        W, C, vpt, px, s)
               : scatter<float>(flow, src, order, g, scratch, M, H, W, C,
                                vpt, px, s);
  if (err != 0 || !bf16) return err;
  return cast(scratch, grad_bf16, n, s);
}

}  // namespace

// feat: contiguous (S, H, W, C), float32 (bf16 = 0) or bfloat16 (bf16 = 1);
// flow: contiguous (M, H, W, 2) float32 in pixels, (u, v); src: (M,) int32 on
// the device, 0 <= src[m] < S; order: (M,) int32 on the device, a
// permutation of 0..M-1 (the launch order of the pairs: grouped by source);
// out: contiguous (M, H, W, C) in feat's type. vpt = 0 launches the scalar
// kernel (one thread per element; order unused); vpt = 1 or 2 the vector
// kernel, each thread owning vpt 16-byte vectors of a pixel's
// channels, which needs C a multiple of 8 * vpt (bf16) or 4 * vpt
// (float32), at most 256 threads a pixel, feat and out 16-byte aligned and
// flow 8-byte aligned. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a vpt or C that the vector kernel does not take.
extern "C" int dis_warp2d_pairs_fwd(const void* feat, const float* flow,
                                    const int* src, const int* order,
                                    void* out, int M, int H, int W, int C,
                                    int bf16, int vpt, void* stream) {
  return bf16 ? fwd<__nv_bfloat16>(feat, flow, src, order, out, M, H, W, C,
                                   vpt, stream)
              : fwd<float>(feat, flow, src, order, out, M, H, W, C, vpt,
                           stream);
}

// flow, src, order as above; g: contiguous (M, H, W, C) float32 or
// bfloat16; scratch: contiguous (S, H, W, C) float32, 16-byte aligned,
// zeroed here on the stream and then the float32 gradient; grad_bf16: for
// bf16 = 1, a contiguous (S, H, W, C) bfloat16 output, 8-byte aligned, that
// the scratch is rounded into (unused for float32). vector = 0 launches the
// scalar scatter (one thread per element, in table order; order unused);
// vector = 1 the vector scatter (each thread one 4-channel vector of 8
// consecutive pixels), which needs C a multiple of 4, at most 256 threads
// a pixel, g aligned to 4 channels (16 bytes in float32, 8 in bfloat16) and
// flow 8-byte aligned. Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a C that the vector scatter does not take.
extern "C" int dis_warp2d_pairs_bwd(const float* flow, const int* src,
                                    const int* order, const void* g,
                                    float* scratch, void* grad_bf16, int S,
                                    int M, int H, int W, int C, int bf16,
                                    int vector, void* stream) {
  return bwd(flow, src, order, g, scratch, grad_bf16, S, M, H, W, C, bf16,
             vector ? 1 : 0, 8, (cudaStream_t)stream);
}

#ifdef DIS_AB_VARIANTS
// For scripts/ab_torch_kernels.py and chip_smoke.py, built with
// -DDIS_AB_VARIANTS only: dis_warp2d_pairs_bwd with the vector scatter's
// shape chosen (vpt = 1 or 2 vectors a thread of px = 1, 2, 4 or 8 pixels;
// vpt = 0 the scalar scatter), and parts = 7 for the whole call or one part
// alone, to time it: the zeroing (1), the scatter (2, onto the scratch as
// it stands) or the cast (4).
extern "C" int dis_ab_warp2d_pairs_bwd(const float* flow, const int* src,
                                       const int* order, const void* g,
                                       float* scratch, void* grad_bf16,
                                       int S, int M, int H, int W, int C,
                                       int bf16, int vpt, int px, int parts,
                                       void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (parts == 7)
    return bwd(flow, src, order, g, scratch, grad_bf16, S, M, H, W, C, bf16,
               vpt, px, s);
  const long long n = (long long)S * H * W * C;
  if (parts == 1) return zero(scratch, n, s);
  if (parts == 4) return bf16 ? cast(scratch, grad_bf16, n, s) : 0;
  if (parts != 2) return (int)cudaErrorInvalidValue;
  return bf16 ? scatter<__nv_bfloat16>(flow, src, order, g, scratch, M, H, W,
                                       C, vpt, px, s)
              : scatter<float>(flow, src, order, g, scratch, M, H, W, C, vpt,
                               px, s);
}
#endif
