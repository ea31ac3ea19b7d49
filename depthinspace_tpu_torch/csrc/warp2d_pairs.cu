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
//     a thread (4 or 8 vectors) in both types. VPT = 4 and 8 stay
//     instantiated for that comparison (scripts/ab_torch_kernels.py);
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
// float atomicAdd into a float32 (S, H, W, C) scratch that the launcher
// zeroes on the stream, one thread per element; for bfloat16 a cast kernel
// then rounds the scratch into the bf16 gradient, as the TPU kernel casts
// its f32 grad_pad. The atomics make the bits of a sum of three or more
// contributions vary from run to run. The TPU kernel's grid needed every
// source in the same number of pairs; this one takes any table with
// 0 <= src[m] < S (the wrapper checks it on the host).

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

__global__ void f32_to_bf16_kernel(const float* __restrict__ x,
                                   __nv_bfloat16* __restrict__ y,
                                   long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
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
    case 4:
      return fwd_vec<T, 4>(feat, flow, src, order, out, M, H, W, C, stream);
    case 8:
      return fwd_vec<T, 8>(feat, flow, src, order, out, M, H, W, C, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int bwd(const float* flow, const int* src, const void* g, float* scratch,
        int S, int M, int H, int W, int C, void* stream) {
  const cudaError_t err = cudaMemsetAsync(
      scratch, 0, sizeof(float) * (size_t)S * H * W * C, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  warp2d_pairs_bwd_kernel<T>
      <<<grid_for(M, H, W, C), kThreads, 0, (cudaStream_t)stream>>>(
          flow, src, (const T*)g, scratch, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

// feat: contiguous (S, H, W, C), float32 (bf16 = 0) or bfloat16 (bf16 = 1);
// flow: contiguous (M, H, W, 2) float32 in pixels, (u, v); src: (M,) int32 on
// the device, 0 <= src[m] < S; order: (M,) int32 on the device, a
// permutation of 0..M-1 (the launch order of the pairs: grouped by source);
// out: contiguous (M, H, W, C) in feat's type. vpt = 0 launches the scalar
// kernel (one thread per element; order unused); vpt = 1, 2, 4 or 8 the
// vector kernel, each thread owning vpt 16-byte vectors of a pixel's
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

// flow, src as above; g: contiguous (M, H, W, C) float32 or bfloat16;
// scratch: contiguous (S, H, W, C) float32, zeroed here on the stream and
// then the float32 gradient; grad_bf16: for bf16 = 1, a contiguous
// (S, H, W, C) bfloat16 output that the scratch is rounded into (unused for
// float32). Returns cudaGetLastError().
extern "C" int dis_warp2d_pairs_bwd(const float* flow, const int* src,
                                    const void* g, float* scratch,
                                    void* grad_bf16, int S, int M, int H,
                                    int W, int C, int bf16, void* stream) {
  if (!bf16)
    return bwd<float>(flow, src, g, scratch, S, M, H, W, C, stream);
  const int err =
      bwd<__nv_bfloat16>(flow, src, g, scratch, S, M, H, W, C, stream);
  if (err != 0) return err;
  const long long n = (long long)S * H * W * C;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 32 ? want : 132 * 32);
  if (blocks > 0)
    f32_to_bf16_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        scratch, (__nv_bfloat16*)grad_bf16, n);
  return (int)cudaGetLastError();
}
