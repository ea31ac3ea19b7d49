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
// disparity is NOT clipped to [0, max_disp] as the TPU host prep does.
//
// What bounds it on the H100: memory. Per pixel it reads one f32 disparity
// and two pattern words and writes one f32, with a handful of operations.
//
// Design: one thread per output pixel, a grid of (row chunks, rows, images)
// so no thread divides to find its pixel; consecutive threads on consecutive
// pixels of a row, so the disparity read and the output write coalesce and
// the two pattern reads hit the same or neighbouring cache lines of one
// row. The pattern is read with a batch stride given by the caller: 0 for
// the (H, W) projector pattern, so the (N, H, W) broadcast is never
// materialized. The TPU kernel's enumeration of D+1 static shifts existed
// because gathers were slow there and is not reproduced. The arithmetic uses
// round-to-nearest intrinsics, which forbid FMA contraction, so the result is
// bit-identical to the plain PyTorch version's separate multiply and add.

#include <cuda_runtime.h>

namespace {

__global__ void xwarp_fwd_kernel(const float* __restrict__ pat,
                                 long long pat_batch_stride,
                                 const float* __restrict__ disp,
                                 float* __restrict__ out, int H, int W) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= W) return;
  const int v = blockIdx.y;
  const long long n = blockIdx.z;
  const long long idx = (n * H + v) * W + u;

  const float x = __fsub_rn((float)u, disp[idx]);
  const float xc = fminf(fmaxf(x, 0.0f), (float)(W - 1));
  const float x0f = floorf(xc);
  const float f = __fsub_rn(xc, x0f);
  const int i0 = (int)x0f;
  const int i1 = min(i0 + 1, W - 1);
  const float* row = pat + n * pat_batch_stride + (long long)v * W;
  out[idx] = __fadd_rn(__fmul_rn(row[i0], __fsub_rn(1.0f, f)),
                       __fmul_rn(row[i1], f));
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
// truth; the TPU kernel clips its shift index to [0, max_disp]). The same
// layout and design as the forward: one thread per pixel, coalesced disp,
// g and output, two pattern reads from one row. Bound by memory.
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
// H*W; disp, out: contiguous (N, H, W) float32. Returns cudaGetLastError().
extern "C" int dis_xwarp_fwd(const float* pat, long long pat_batch_stride,
                             const float* disp, float* out, int N, int H,
                             int W, void* stream) {
  const int threads = 128;
  const dim3 grid((W + threads - 1) / threads, H, N);
  xwarp_fwd_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      pat, pat_batch_stride, disp, out, H, W);
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
