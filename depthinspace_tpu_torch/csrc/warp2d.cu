// Bilinear flow warp with zeros padding, forward (kernels K3 and K5).
//
// Replaces: depthinspace_tpu/ops/pallas/warp2d_v2.py::_v2_fwd (the Pallas
// body _fwd_kernel), reached through warp2d_v2 from
// ops/resample.py::flow_warp, and depthinspace_tpu/ops/pallas/
// warp_kernel.py::warp2d (K5), reached through ops/resample.py::warp2d_v1.
//
//   out(p) = img(p + flow(p)), bilinear; each of the four corners whose
//   integer index lies outside the image contributes 0 (torch grid_sample
//   zeros padding, as ops/sampling.py::bilinear_sample checks per corner).
//
// It is unbounded, like the CPU truth ops/sampling.py::warp: the TPU kernel
// drops integer offsets beyond +-19 px (_effective_shift(16)); this one
// samples any offset.
//
// What bounds it on the H100: memory. Per pixel it reads one flow float2
// and four data-dependent corners of C channels, and writes C; for the
// smooth few-pixel flows of the geometric losses the corners of
// neighbouring pixels are neighbours too, so the gathers mostly hit L1/L2
// and the byte bound counts the image once. The main paths run C = 1, 3 and
// 5 (the SF and MF geometric losses, FuseNet's geometry warp).
//
// The first design ran one thread per pixel on a grid of (128-pixel chunks
// of a row, rows, images), looping over a runtime C: at W = 432 the last
// chunk of each row left 80 of 128 lanes idle, the four gathers of a
// channel were issued one channel after another, the flow came as two
// 4-byte loads and C = 3 or 5 channels were stored as scalar words at a
// 12- or 20-byte pitch. It lost to grid_sample. The vector kernel:
//   - walks a flat pixel index over M*H*W in blocks of 256 threads, so no
//     row leaves a ragged block (only the last block of the call);
//   - takes C as a template parameter (1..8) and issues all 4*C corner
//     loads (__ldg, read-only path) before the first product;
//   - reads the flow as one float2 a pixel, or for C = 1 with two pixels a
//     thread as float4s, and stores their two outputs as one float2 (a
//     scalar tail where the call's pixel count is odd); one pixel a thread
//     where flow or out is not 16-byte aligned.
// Two variants lost to it at the main paths' shapes and are built only for
// scripts/ab_torch_kernels.py (-DDIS_AB_VARIANTS): four pixels a thread at
// C = 1 (3 % slower than two), and for C >= 2 the block's 256*C outputs, which
// are contiguous, staged in shared memory and written back as 16-byte
// stores (5 % slower at C = 3, level at C = 5: L2 merges the direct
// stores, which do not bound the kernel).
// It reaches 72-79 % of the byte bound at the main paths' shapes and beats
// grid_sample at each of them. ops/kernels.py::warp2d_fwd_path chooses the
// kernel by C and the pointers' alignment; the first design stays as the
// path for C > 8, a flow not 8-byte aligned or more than 2^31 - 1025
// pixels. Both compute the same taps and each channel's
// v00*w00 + v01*w01 + v10*w10 + v11*w11 in that order with round-to-nearest
// intrinsics (no FMA contraction), so they match the plain version bit for
// bit. The TPU kernel's band windows, static offset enumeration and
// scalar-prefetch ranges existed because gathers were slow there and are
// not reproduced.

#include <cuda_runtime.h>

namespace {

// The bilinear taps of pixel (u, v) displaced by (fx, fy): the corner
// weights, the corners (clamped before the integer conversion so a huge or
// NaN coordinate cannot overflow; every clamped value stays outside the
// image, as it was), their validity and their indices clamped into the
// image (only read where valid).
struct Taps {
  float w[4];
  int cx0, cx1, cy0, cy1;
  bool valid[4];
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
  t.w[0] = __fmul_rn(wy0, wx0);
  t.w[1] = __fmul_rn(wy0, wx1);
  t.w[2] = __fmul_rn(wy1, wx0);
  t.w[3] = __fmul_rn(wy1, wx1);
  const int x0 = (int)fminf(fmaxf(x0f, -2.0f), (float)(W + 1));
  const int y0 = (int)fminf(fmaxf(y0f, -2.0f), (float)(H + 1));
  const int x1 = x0 + 1;
  const int y1 = y0 + 1;
  const bool vx0 = x0 >= 0 && x0 <= W - 1;
  const bool vx1 = x1 >= 0 && x1 <= W - 1;
  const bool vy0 = y0 >= 0 && y0 <= H - 1;
  const bool vy1 = y1 >= 0 && y1 <= H - 1;
  t.valid[0] = vy0 && vx0;
  t.valid[1] = vy0 && vx1;
  t.valid[2] = vy1 && vx0;
  t.valid[3] = vy1 && vx1;
  t.cx0 = min(max(x0, 0), W - 1);
  t.cx1 = min(max(x1, 0), W - 1);
  t.cy0 = min(max(y0, 0), H - 1);
  t.cy1 = min(max(y1, 0), H - 1);
  return t;
}

__device__ __forceinline__ float bilinear(const float (&v)[4],
                                          const float (&w)[4]) {
  float acc = __fmul_rn(v[0], w[0]);
  acc = __fadd_rn(acc, __fmul_rn(v[1], w[1]));
  acc = __fadd_rn(acc, __fmul_rn(v[2], w[2]));
  return __fadd_rn(acc, __fmul_rn(v[3], w[3]));
}

// The first design, the path for any C: one thread per output pixel on a
// grid of (row chunks, rows, images), looping over the C channels.
__global__ void warp2d_fwd_kernel(const float* __restrict__ img,
                                  const float* __restrict__ flow,
                                  float* __restrict__ out, int H, int W,
                                  int C) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= W) return;
  const int v = blockIdx.y;
  const long long m = blockIdx.z;
  const long long p = (m * H + v) * W + u;
  const Taps t = taps_at(flow[2 * p], flow[2 * p + 1], u, v, H, W);

  const float* base = img + m * H * (long long)W * C;
  const float* corner[4] = {base + ((long long)t.cy0 * W + t.cx0) * C,
                            base + ((long long)t.cy0 * W + t.cx1) * C,
                            base + ((long long)t.cy1 * W + t.cx0) * C,
                            base + ((long long)t.cy1 * W + t.cx1) * C};
  float* o = out + p * C;
  for (int c = 0; c < C; ++c) {
    float val[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) val[q] = t.valid[q] ? corner[q][c] : 0.0f;
    o[c] = bilinear(val, t.w);
  }
}

constexpr int kThreads = 256;

// Warps pixels [first, first + count) of the flat (M*H*W) index, 1 <= count
// <= P, into res: the flows first (float2 each, or float4 pairs when all P
// pixels are there), then every corner load in flight before the first
// product.
template <int C, int P>
__device__ __forceinline__ void warp_pixels(const float* __restrict__ img,
                                            const float* __restrict__ flow,
                                            int H, int W, int first,
                                            int count, float (&res)[P][C]) {
  float2 f[P];
  if constexpr (P == 1) {
    f[0] = __ldg(reinterpret_cast<const float2*>(flow) + first);
  } else if (count == P) {
#pragma unroll
    for (int k = 0; k < P; k += 2) {
      const float4 f4 =
          __ldg(reinterpret_cast<const float4*>(flow + 2 * (first + k)));
      f[k] = make_float2(f4.x, f4.y);
      f[k + 1] = make_float2(f4.z, f4.w);
    }
  } else {
#pragma unroll
    for (int k = 0; k < P; ++k)
      f[k] = k < count
                 ? __ldg(reinterpret_cast<const float2*>(flow) + first + k)
                 : make_float2(0.0f, 0.0f);
  }

  // the first pixel's (image, row, column); the others step along it
  int r = first / W;
  int u = first - r * W;
  int m = r / H;
  int v = r - m * H;
  Taps t[P];
  const float* corner[P][4];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    t[k] = taps_at(f[k].x, f[k].y, u, v, H, W);
    const float* base = img + (long long)m * H * W * C;
    corner[k][0] = base + ((long long)t[k].cy0 * W + t[k].cx0) * C;
    corner[k][1] = base + ((long long)t[k].cy0 * W + t[k].cx1) * C;
    corner[k][2] = base + ((long long)t[k].cy1 * W + t[k].cx0) * C;
    corner[k][3] = base + ((long long)t[k].cy1 * W + t[k].cx1) * C;
    if (++u == W) {
      u = 0;
      if (++v == H) {
        v = 0;
        ++m;
      }
    }
  }

  float val[P][C][4];
#pragma unroll
  for (int k = 0; k < P; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < C; ++c)
        val[k][c][q] =
            (k < count && t[k].valid[q]) ? __ldg(corner[k][q] + c) : 0.0f;
#pragma unroll
  for (int k = 0; k < P; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c) res[k][c] = bilinear(val[k][c], t[k].w);
}

// The vector kernel: thread i of the call owns pixels [i*P, i*P + P) of
// the flat (M*H*W) index, n pixels in all; C channels, P pixels a thread
// for C = 1 (their outputs stored as one float2 or float4).
template <int C, int P>
__global__ void __launch_bounds__(kThreads)
    warp2d_fwd_vec_kernel(const float* __restrict__ img,
                          const float* __restrict__ flow,
                          float* __restrict__ out, int H, int W, int n) {
  static_assert(P == 1 || C == 1, "several pixels a thread only for C = 1");
  const int first = (blockIdx.x * kThreads + threadIdx.x) * P;
  // threads past the end fall through to the guarded stores (an early
  // return here compiled to a slower kernel at C = 5)
  const int count = max(0, min(P, n - first));
  float res[P][C];
  if (count > 0) warp_pixels<C, P>(img, flow, H, W, first, count, res);
  if (count == P && P == 2) {
    if constexpr (P == 2)
      *reinterpret_cast<float2*>(out + first) =
          make_float2(res[0][0], res[1][0]);
  } else if (count == P && P == 4) {
    if constexpr (P == 4)
      *reinterpret_cast<float4*>(out + first) =
          make_float4(res[0][0], res[1][0], res[2][0], res[3][0]);
  } else {
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (k < count) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          out[(long long)(first + k) * C + c] = res[k][c];
      }
  }
}

template <int C, int P>
int fwd_vec(const float* img, const float* flow, float* out, int n, int H,
            int W, cudaStream_t stream) {
  const int per_block = kThreads * P;
  const int blocks = (n + per_block - 1) / per_block;
  warp2d_fwd_vec_kernel<C, P>
      <<<blocks, kThreads, 0, stream>>>(img, flow, out, H, W, n);
  return (int)cudaGetLastError();
}

template <int C>
int fwd_vec_c(const float* img, const float* flow, float* out, int n, int H,
              int W, int ppt, cudaStream_t stream) {
  if (ppt == 1) return fwd_vec<C, 1>(img, flow, out, n, H, W, stream);
  if constexpr (C == 1) {
    if (ppt == 2) return fwd_vec<1, 2>(img, flow, out, n, H, W, stream);
#ifdef DIS_AB_VARIANTS
    if (ppt == 4) return fwd_vec<1, 4>(img, flow, out, n, H, W, stream);
#endif
  }
  return (int)cudaErrorInvalidValue;
}

int fwd(const float* img, const float* flow, float* out, int M, int H, int W,
        int C, int ppt, cudaStream_t s) {
  if (ppt == 0) {
    const dim3 grid((W + 127) / 128, H, M);
    warp2d_fwd_kernel<<<grid, 128, 0, s>>>(img, flow, out, H, W, C);
    return (int)cudaGetLastError();
  }
  const long long total = (long long)M * H * W;
  if (total >= (1LL << 31) - 1024) return (int)cudaErrorInvalidValue;
  const int n = (int)total;
  switch (C) {
    case 1: return fwd_vec_c<1>(img, flow, out, n, H, W, ppt, s);
    case 2: return fwd_vec_c<2>(img, flow, out, n, H, W, ppt, s);
    case 3: return fwd_vec_c<3>(img, flow, out, n, H, W, ppt, s);
    case 4: return fwd_vec_c<4>(img, flow, out, n, H, W, ppt, s);
    case 5: return fwd_vec_c<5>(img, flow, out, n, H, W, ppt, s);
    case 6: return fwd_vec_c<6>(img, flow, out, n, H, W, ppt, s);
    case 7: return fwd_vec_c<7>(img, flow, out, n, H, W, ppt, s);
    case 8: return fwd_vec_c<8>(img, flow, out, n, H, W, ppt, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

#ifdef DIS_AB_VARIANTS
// Built only for scripts/ab_torch_kernels.py (-DDIS_AB_VARIANTS), which
// measured it against the direct stores: one pixel a thread, the block's
// 256*C outputs, which are contiguous, staged in shared memory and written
// back as 16-byte stores. Slower at C = 3, level at C = 5.
template <int C>
__global__ void __launch_bounds__(kThreads)
    warp2d_fwd_staged_kernel(const float* __restrict__ img,
                             const float* __restrict__ flow,
                             float* __restrict__ out, int H, int W, int n) {
  __shared__ __align__(16) float tile[kThreads * C];
  const int first = blockIdx.x * kThreads + threadIdx.x;
  if (first < n) {
    float res[1][C];
    warp_pixels<C, 1>(img, flow, H, W, first, 1, res);
#pragma unroll
    for (int c = 0; c < C; ++c) tile[threadIdx.x * C + c] = res[0][c];
  }
  __syncthreads();
  const int start = blockIdx.x * kThreads;
  const int nf = min(kThreads, n - start) * C;
  float* o = out + (long long)start * C;
  const int nv = nf / 4;
  for (int i = threadIdx.x; i < nv; i += kThreads)
    reinterpret_cast<float4*>(o)[i] = reinterpret_cast<const float4*>(tile)[i];
  for (int i = 4 * nv + threadIdx.x; i < nf; i += kThreads) o[i] = tile[i];
}

template <int C>
int fwd_staged(const float* img, const float* flow, float* out, int n, int H,
               int W, cudaStream_t stream) {
  warp2d_fwd_staged_kernel<C><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                                stream>>>(img, flow, out, H, W, n);
  return (int)cudaGetLastError();
}
#endif

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
// float32 in pixels, (u, v). ppt = 0 launches the first design (any C;
// at most 65535 images and rows). ppt = 1 launches the vector kernel with
// one pixel a thread, which takes C in 1..8, M*H*W < 2^31 - 1024 and a
// flow 8-byte aligned; ppt = 2 (C = 1 only) with two pixels a thread, which
// also needs flow and out 16-byte aligned. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a ppt or C that the vector
// kernel does not take.
extern "C" int dis_warp2d_fwd(const float* img, const float* flow, float* out,
                              int M, int H, int W, int C, int ppt,
                              void* stream) {
  return fwd(img, flow, out, M, H, W, C, ppt, (cudaStream_t)stream);
}

#ifdef DIS_AB_VARIANTS
// dis_warp2d_fwd, and the variants that lost: ppt = 4 (C = 1, flow and out
// 16-byte aligned), and staged = 1 (C in 2..8, one pixel a thread, out
// 16-byte aligned).
extern "C" int dis_ab_warp2d_fwd(const float* img, const float* flow,
                                 float* out, int M, int H, int W, int C,
                                 int ppt, int staged, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (!staged) return fwd(img, flow, out, M, H, W, C, ppt, s);
  const long long total = (long long)M * H * W;
  if (ppt != 1 || total >= (1LL << 31) - 1024)
    return (int)cudaErrorInvalidValue;
  const int n = (int)total;
  switch (C) {
    case 2: return fwd_staged<2>(img, flow, out, n, H, W, s);
    case 3: return fwd_staged<3>(img, flow, out, n, H, W, s);
    case 4: return fwd_staged<4>(img, flow, out, n, H, W, s);
    case 5: return fwd_staged<5>(img, flow, out, n, H, W, s);
    case 6: return fwd_staged<6>(img, flow, out, n, H, W, s);
    case 7: return fwd_staged<7>(img, flow, out, n, H, W, s);
    case 8: return fwd_staged<8>(img, flow, out, n, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif

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
