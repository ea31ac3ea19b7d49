// Bilinear flow warp with zeros padding, forward (kernel K3).
//
// Replaces: depthinspace_tpu/ops/pallas/warp2d_v2.py::_v2_fwd (the Pallas
// body _fwd_kernel), reached through warp2d_v2 from
// ops/resample.py::flow_warp.
//
//   out(p) = img(p + flow(p)), bilinear; each of the four corners whose
//   integer index lies outside the image contributes 0 (torch grid_sample
//   zeros padding, as ops/sampling.py::bilinear_sample checks per corner).
//
// It is unbounded, like the CPU truth ops/sampling.py::warp: the TPU kernel
// drops integer offsets beyond +-19 px (_effective_shift(16)); this one
// samples any offset.
//
// What bounds it on the H100: memory and gathers. Per pixel it reads two
// flow words and four data-dependent corners of C channels, and writes C.
//
// Design: NHWC, one thread per output pixel, looping over the C channels,
// on a grid of (row chunks, rows, images) so no thread divides to find its
// pixel. The corner weights and validity are computed once per pixel and
// reused for every channel; the C channels of a corner are contiguous, so one
// thread's corner reads share cache lines. For the smooth few-pixel flows
// of the geometric loss the corners of neighbouring threads are neighbours
// too and the gathers mostly hit L1/L2. The TPU kernel's band windows,
// static offset enumeration and scalar-prefetch ranges existed because
// gathers were slow there and are not reproduced. The arithmetic uses
// round-to-nearest intrinsics (no FMA contraction) in the plain version's
// order of operations, so the result matches it bit for bit.

#include <cuda_runtime.h>

namespace {

__global__ void warp2d_fwd_kernel(const float* __restrict__ img,
                                  const float* __restrict__ flow,
                                  float* __restrict__ out, int H, int W,
                                  int C) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= W) return;
  const int v = blockIdx.y;
  const long long m = blockIdx.z;
  const long long p = (m * H + v) * W + u;

  const float gx = __fadd_rn(flow[2 * p], (float)u);
  const float gy = __fadd_rn(flow[2 * p + 1], (float)v);
  const float x0f = floorf(gx);
  const float y0f = floorf(gy);
  const float wx1 = __fsub_rn(gx, x0f);
  const float wy1 = __fsub_rn(gy, y0f);
  const float wx0 = __fsub_rn(1.0f, wx1);
  const float wy0 = __fsub_rn(1.0f, wy1);
  const float w00 = __fmul_rn(wy0, wx0);
  const float w01 = __fmul_rn(wy0, wx1);
  const float w10 = __fmul_rn(wy1, wx0);
  const float w11 = __fmul_rn(wy1, wx1);

  // Clamp before the integer conversion so a huge or NaN coordinate cannot
  // overflow; every clamped value stays outside the image, as it was.
  const int x0 = (int)fminf(fmaxf(x0f, -2.0f), (float)(W + 1));
  const int y0 = (int)fminf(fmaxf(y0f, -2.0f), (float)(H + 1));
  const int x1 = x0 + 1;
  const int y1 = y0 + 1;
  const bool vx0 = x0 >= 0 && x0 <= W - 1;
  const bool vx1 = x1 >= 0 && x1 <= W - 1;
  const bool vy0 = y0 >= 0 && y0 <= H - 1;
  const bool vy1 = y1 >= 0 && y1 <= H - 1;
  const int cx0 = min(max(x0, 0), W - 1);
  const int cx1 = min(max(x1, 0), W - 1);
  const int cy0 = min(max(y0, 0), H - 1);
  const int cy1 = min(max(y1, 0), H - 1);

  const float* base = img + m * H * (long long)W * C;
  const float* p00 = base + ((long long)cy0 * W + cx0) * C;
  const float* p01 = base + ((long long)cy0 * W + cx1) * C;
  const float* p10 = base + ((long long)cy1 * W + cx0) * C;
  const float* p11 = base + ((long long)cy1 * W + cx1) * C;
  float* o = out + p * C;
  for (int c = 0; c < C; ++c) {
    const float v00 = (vy0 && vx0) ? p00[c] : 0.0f;
    const float v01 = (vy0 && vx1) ? p01[c] : 0.0f;
    const float v10 = (vy1 && vx0) ? p10[c] : 0.0f;
    const float v11 = (vy1 && vx1) ? p11[c] : 0.0f;
    float acc = __fmul_rn(v00, w00);
    acc = __fadd_rn(acc, __fmul_rn(v01, w01));
    acc = __fadd_rn(acc, __fmul_rn(v10, w10));
    o[c] = __fadd_rn(acc, __fmul_rn(v11, w11));
  }
}

// Flow warp backward (kernel K3 bwd), the adjoint to img only.
//
// Replaces: depthinspace_tpu/ops/pallas/warp2d_v2.py::_v2_bwd (the Pallas
// body _bwd_kernel). CPU truth: autodiff of ops/sampling.py::warp wrt img
// (the flow is data and gets no gradient).
//
//   grad_img[corner c of p] += w_c(p) * g(p)   for each VALID corner c
//
// A scatter: one thread per pixel p, the same weights and validity as the
// forward (so the same clamp before the int conversion and no +-max_shift
// bound), and a float atomicAdd per valid corner and channel into an output
// that the launcher zeroes first. The atomics make the bits of a sum of
// three or more contributions vary from run to run. Bound by memory: flow
// and g read once, the output zeroed and then updated in L2.
__global__ void warp2d_bwd_kernel(const float* __restrict__ flow,
                                  const float* __restrict__ g,
                                  float* __restrict__ grad, int H, int W,
                                  int C) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= W) return;
  const int v = blockIdx.y;
  const long long m = blockIdx.z;
  const long long p = (m * H + v) * W + u;

  const float gx = __fadd_rn(flow[2 * p], (float)u);
  const float gy = __fadd_rn(flow[2 * p + 1], (float)v);
  const float x0f = floorf(gx);
  const float y0f = floorf(gy);
  const float wx1 = __fsub_rn(gx, x0f);
  const float wy1 = __fsub_rn(gy, y0f);
  const float wx0 = __fsub_rn(1.0f, wx1);
  const float wy0 = __fsub_rn(1.0f, wy1);
  const float w00 = __fmul_rn(wy0, wx0);
  const float w01 = __fmul_rn(wy0, wx1);
  const float w10 = __fmul_rn(wy1, wx0);
  const float w11 = __fmul_rn(wy1, wx1);

  const int x0 = (int)fminf(fmaxf(x0f, -2.0f), (float)(W + 1));
  const int y0 = (int)fminf(fmaxf(y0f, -2.0f), (float)(H + 1));
  const int x1 = x0 + 1;
  const int y1 = y0 + 1;
  const bool vx0 = x0 >= 0 && x0 <= W - 1;
  const bool vx1 = x1 >= 0 && x1 <= W - 1;
  const bool vy0 = y0 >= 0 && y0 <= H - 1;
  const bool vy1 = y1 >= 0 && y1 <= H - 1;

  float* base = grad + m * H * (long long)W * C;
  const float* gp = g + p * C;
  for (int c = 0; c < C; ++c) {
    const float gc = gp[c];
    if (vy0 && vx0)
      atomicAdd(base + ((long long)y0 * W + x0) * C + c, __fmul_rn(gc, w00));
    if (vy0 && vx1)
      atomicAdd(base + ((long long)y0 * W + x1) * C + c, __fmul_rn(gc, w01));
    if (vy1 && vx0)
      atomicAdd(base + ((long long)y1 * W + x0) * C + c, __fmul_rn(gc, w10));
    if (vy1 && vx1)
      atomicAdd(base + ((long long)y1 * W + x1) * C + c, __fmul_rn(gc, w11));
  }
}

}  // namespace

// img, out: contiguous (M, H, W, C) float32; flow: contiguous (M, H, W, 2)
// float32 in pixels, (u, v). Returns cudaGetLastError() after the launch.
extern "C" int dis_warp2d_fwd(const float* img, const float* flow, float* out,
                              int M, int H, int W, int C, void* stream) {
  const int threads = 128;
  const dim3 grid((W + threads - 1) / threads, H, M);
  warp2d_fwd_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      img, flow, out, H, W, C);
  return (int)cudaGetLastError();
}

// flow: contiguous (M, H, W, 2); g, grad: contiguous (M, H, W, C) float32.
// Zeroes grad on the stream, then scatters. Returns cudaGetLastError().
extern "C" int dis_warp2d_bwd(const float* flow, const float* g, float* grad,
                              int M, int H, int W, int C, void* stream) {
  const cudaError_t err = cudaMemsetAsync(
      grad, 0, sizeof(float) * (size_t)M * H * W * C, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const int threads = 128;
  const dim3 grid((W + threads - 1) / threads, H, M);
  warp2d_bwd_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      flow, g, grad, H, W, C);
  return (int)cudaGetLastError();
}
