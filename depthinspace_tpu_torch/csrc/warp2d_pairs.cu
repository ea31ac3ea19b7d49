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
// the int conversion are K3's, in the plain version's order with
// round-to-nearest intrinsics, so float32 is bit-exact to the plain
// version. Unlike K3 (one thread per pixel, looping over its few channels),
// a thread computes one (pixel, channel) element, on a grid of (chunks of a
// row's W*C elements, rows, pairs): with C = 32 a warp is one pixel, so its
// corner loads, its store and (backward) its atomics are 32 contiguous
// elements instead of 32 addresses C elements apart; each thread recomputes
// its pixel's taps from the flow word the warp shares. bfloat16
// features are loaded with __bfloat162float, weighted and summed in float32
// and rounded once at the store, as the TPU kernel DMAs bf16, accumulates in
// f32 and casts at the end. Unbounded like the CPU truth
// (ops/sampling.py::warp): no offset beyond +-19 px is dropped.
// The TPU kernel's band windows, offset enumeration, scalar-prefetched range
// tables and source-major grid existed because gathers were slow there.
//
// What bounds it on the H100: memory. Per pixel it reads two flow words and
// four data-dependent corners of C channels (C = 32 bf16 is 64 contiguous
// bytes per corner) and writes C; for the smooth flows of a track the
// corners of neighbouring pixels are neighbours and mostly hit L1/L2.
//
// The backward scatters w*g to the four valid corners of plane src[m] with
// float atomicAdd into a float32 (S, H, W, C) scratch that the launcher
// zeroes on the stream; for bfloat16 a cast kernel then rounds the scratch
// into the bf16 gradient, as the TPU kernel casts its f32 grad_pad. The
// atomics make the bits of a sum of three or more contributions vary from
// run to run. The TPU kernel's grid needed every source in the same number
// of pairs; this one takes any table with 0 <= src[m] < S (the wrapper
// checks it on the host).

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

__device__ __forceinline__ Taps taps(const float* __restrict__ flow,
                                     long long p, int u, int v, int H,
                                     int W) {
  Taps t;
  const float gx = __fadd_rn(flow[2 * p], (float)u);
  const float gy = __fadd_rn(flow[2 * p + 1], (float)v);
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
int fwd(const void* feat, const float* flow, const int* src, void* out, int M,
        int H, int W, int C, void* stream) {
  warp2d_pairs_fwd_kernel<T>
      <<<grid_for(M, H, W, C), kThreads, 0, (cudaStream_t)stream>>>(
          (const T*)feat, flow, src, (T*)out, H, W, C);
  return (int)cudaGetLastError();
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
// the device, 0 <= src[m] < S; out: contiguous (M, H, W, C) in feat's type.
// Returns cudaGetLastError() after the launch.
extern "C" int dis_warp2d_pairs_fwd(const void* feat, const float* flow,
                                    const int* src, void* out, int M, int H,
                                    int W, int C, int bf16, void* stream) {
  return bf16 ? fwd<__nv_bfloat16>(feat, flow, src, out, M, H, W, C, stream)
              : fwd<float>(feat, flow, src, out, M, H, W, C, stream);
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
