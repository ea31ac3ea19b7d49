// Pattern warp by disparity, forward (kernel K2).
//
// Replaces: depthinspace_tpu/ops/pallas/warp_kernel.py::_xwarp_fwd (the
// Pallas body _xwarp_fwd_kernel), reached through xwarp_disparity from
// ops/resample.py::warp_pattern.
//
//   x = u - disp(p);  xc = clamp(x, 0, W-1);  x0 = floor(xc);  f = xc - x0
//   out(p) = pat[v, x0] * (1 - f) + pat[v, min(x0 + 1, W-1)] * f
//
// This follows the CPU truth losses/photometric.py::_xwarp_fwd_impl: the
// disparity is NOT clipped to [0, max_disp] as the TPU host prep does. The
// arithmetic uses round-to-nearest intrinsics, which forbid FMA
// contraction, so the result is bit-identical to the plain PyTorch
// version's separate multiply and add. The TPU kernel's enumeration of D+1
// static shifts existed because gathers were slow there and is not
// reproduced.
//
// What bounds it on the H100: memory. Per pixel it reads one f32 disparity
// and writes one f32, with a handful of operations; the pattern is read
// once per row. At (8, 512, 432) that is 15 MB, 4.5 us at 3.35 TB/s, so
// what limits it is how many bytes are in flight. One thread per pixel
// (the backward's layout) has 4 bytes in flight and then two dependent
// 4-byte pattern loads before it can store, and at W = 432 leaves 80 of
// every 512 threads idle. This design:
//   - a block takes one row v of a group of images; it stages the pattern's
//     row in shared memory once (the (H, W) projector pattern, pattern
//     stride 0, serves all images of the group; an (N, H, W) pattern stages
//     each image's row), so both taps read shared memory and the dependent
//     global round trip is gone;
//   - a thread owns 4 pixels: 16-byte float4 disparity loads and output
//     stores, and the block's (image, 4-pixel) items are spread over its
//     threads as one flat list, so a 432-wide row (108 items) leaves no
//     ragged block; each thread first starts the disparity loads of up to
//     four items, then the staging loads, so both round trips overlap, and
//     loads the next four while the previous ones are stored;
//   - with W % 4 != 0 or a pointer not 16-byte aligned (the rows do not
//     start on 16 bytes) the same kernel runs with one pixel an item.
// The staging is at most one 16-byte load a thread for the projector
// pattern (a few for an (N, H, W) one at W = 432), started behind the
// disparity loads, so cp.async or a bulk copy was not tried: there is no
// round trip left for it to hide.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// disparity items each thread has in flight
constexpr int kBatch = 4;

template <int VEC>
struct Pix;

template <>
struct Pix<4> {
  using Raw = float4;
  static __device__ void get(const Raw& r, float (&f)[4]) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
  static __device__ Raw make(const float (&f)[4]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Pix<1> {
  using Raw = float;
  static __device__ void get(const Raw& r, float (&f)[1]) { f[0] = r; }
  static __device__ Raw make(const float (&f)[1]) { return f[0]; }
};

__device__ __forceinline__ float xwarp_tap(const float* row, float d, int u,
                                           int W) {
  const float x = __fsub_rn((float)u, d);
  const float xc = fminf(fmaxf(x, 0.0f), (float)(W - 1));
  const float x0f = floorf(xc);
  const float f = __fsub_rn(xc, x0f);
  const int i0 = (int)x0f;
  const int i1 = min(i0 + 1, W - 1);
  return __fadd_rn(__fmul_rn(row[i0], __fsub_rn(1.0f, f)),
                   __fmul_rn(row[i1], f));
}

// Block (v, g): row v of images [g*G, min((g+1)*G, N)). Items are (image,
// group of VEC pixels) of that row, image-major; item e of the block is
// image e / Wv, pixels [(e % Wv) * VEC, +VEC). rows: the pattern rows in
// shared memory, one (stride 0) or one per image of the group.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    xwarp_fwd_kernel(const float* __restrict__ pat,
                     long long pat_batch_stride,
                     const float* __restrict__ disp,
                     float* __restrict__ out, int N, int H, int W, int G) {
  using P = Pix<VEC>;
  using Raw = typename P::Raw;
  extern __shared__ float rows[];
  const int v = blockIdx.x;
  const int n0 = blockIdx.y * G;
  const int ng = min(G, N - n0);
  const int Wv = W / VEC;
  const int items = ng * Wv;
  // the pixel (n0, v, 0) and the stride from one image's row to the next
  const long long first = ((long long)n0 * H + v) * W;
  const long long img = (long long)H * W;
  const Raw* d = reinterpret_cast<const Raw*>(disp + first);
  Raw* o = reinterpret_cast<Raw*>(out + first);
  const long long img_v = img / VEC;

  // the first batch of disparity loads, ahead of the staging
  Raw dv[kBatch] = {};
  int e = threadIdx.x;
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const int ek = e + k * kThreads;
    if (ek < items) dv[k] = d[(ek / Wv) * img_v + ek % Wv];
  }

  const int staged = pat_batch_stride == 0 ? 1 : ng;
  const Raw* prow = reinterpret_cast<const Raw*>(
      pat + (pat_batch_stride == 0 ? 0 : n0 * pat_batch_stride) +
      (long long)v * W);
  const long long pat_v = pat_batch_stride / VEC;
  Raw* srow = reinterpret_cast<Raw*>(rows);
  for (int i = threadIdx.x; i < staged * Wv; i += kThreads)
    srow[i] = prow[(i / Wv) * pat_v + i % Wv];
  __syncthreads();

  for (; e < items; e += kBatch * kThreads) {
    Raw next[kBatch] = {};
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int ek = e + (k + kBatch) * kThreads;
      if (ek < items) next[k] = d[(ek / Wv) * img_v + ek % Wv];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int ek = e + k * kThreads;
      if (ek >= items) break;
      const int nl = ek / Wv;
      const int u0 = (ek - nl * Wv) * VEC;
      const float* row = rows + (staged == 1 ? 0 : nl * W);
      float dd[VEC], res[VEC];
      P::get(dv[k], dd);
#pragma unroll
      for (int j = 0; j < VEC; ++j) res[j] = xwarp_tap(row, dd[j], u0 + j, W);
      o[nl * img_v + (ek - nl * Wv)] = P::make(res);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) dv[k] = next[k];
  }
}

// Pattern warp backward (kernel K2 bwd), the adjoint to disp only.
//
// Replaces: depthinspace_tpu/ops/pallas/warp_kernel.py::_xwarp_vjp_bwd (the
// Pallas body _xwarp_grad_kernel). CPU truth:
// losses/photometric.py::_xwarp_bwd.
//
//   grad_disp(p) = -(pat[v, i1] - pat[v, i0]) * inside * g(p),
//   inside = 0 < u - disp < W-1 (strict: no gradient where the clamp holds)
//
// with x0, i0, i1 as in the forward, and no clip of the disparity (the CPU
// truth; the TPU kernel clips its shift index to [0, max_disp]). One thread
// per pixel on (row chunks, rows, images) blocks of 128: coalesced disp, g
// and output, two pattern reads from one row (the forward's first design).
// Bound by memory.
__global__ void xwarp_bwd_kernel(const float* __restrict__ pat,
                                 long long pat_batch_stride,
                                 const float* __restrict__ disp,
                                 const float* __restrict__ g,
                                 float* __restrict__ grad, int H, int W) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= W) return;
  const int v = blockIdx.y;
  const long long n = blockIdx.z;
  const long long idx = (n * H + v) * W + u;

  const float x = __fsub_rn((float)u, disp[idx]);
  const float xc = fminf(fmaxf(x, 0.0f), (float)(W - 1));
  const int i0 = (int)floorf(xc);
  const int i1 = min(i0 + 1, W - 1);
  const float* row = pat + n * pat_batch_stride + (long long)v * W;
  const bool inside = x > 0.0f && x < (float)(W - 1);
  grad[idx] = inside ? __fmul_rn(-__fsub_rn(row[i1], row[i0]), g[idx]) : 0.0f;
}

}  // namespace

// pat: contiguous (H, W) with pat_batch_stride 0, or (N, H, W) with stride
// H*W; disp, out: contiguous (N, H, W) float32; vec: the pixels a thread
// item holds, 4 (W % 4 == 0 and all three pointers 16-byte aligned) or 1.
// At most 12288 columns (a row of each staged image in 48 KB of shared
// memory). Returns cudaGetLastError(), or cudaErrorInvalidValue for a vec or
// W that the kernel does not take.
extern "C" int dis_xwarp_fwd(const float* pat, long long pat_batch_stride,
                             const float* disp, float* out, int N, int H,
                             int W, int vec, void* stream) {
  constexpr int kMaxFloats = 48 * 1024 / 4;
  const bool aligned =
      W % 4 == 0 &&
      ((reinterpret_cast<unsigned long long>(pat) |
        reinterpret_cast<unsigned long long>(disp) |
        reinterpret_cast<unsigned long long>(out)) & 15) == 0;
  if (W > kMaxFloats || (vec != 1 && vec != 4) || (vec == 4 && !aligned))
    return (int)cudaErrorInvalidValue;
  // about one batch of items a thread; an (N, H, W) pattern stages a row of
  // each of the group's images
  int G = min(N, max(1, kBatch * kThreads * vec / W));
  if (pat_batch_stride != 0) G = min(G, kMaxFloats / W);
  const dim3 grid(H, (N + G - 1) / G);
  const size_t smem = sizeof(float) * W * (pat_batch_stride == 0 ? 1 : G);
  if (vec == 4)
    xwarp_fwd_kernel<4><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        pat, pat_batch_stride, disp, out, N, H, W, G);
  else
    xwarp_fwd_kernel<1><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        pat, pat_batch_stride, disp, out, N, H, W, G);
  return (int)cudaGetLastError();
}

// pat as for dis_xwarp_fwd; disp, g, grad: contiguous (N, H, W) float32.
// Returns cudaGetLastError().
extern "C" int dis_xwarp_bwd(const float* pat, long long pat_batch_stride,
                             const float* disp, const float* g, float* grad,
                             int N, int H, int W, void* stream) {
  const int threads = 128;
  const dim3 grid((W + threads - 1) / threads, H, N);
  xwarp_bwd_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      pat, pat_batch_stride, disp, g, grad, H, W);
  return (int)cudaGetLastError();
}
