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

#include <climits>

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

// Flow warp backward (kernels K3 bwd and K5 bwd), the adjoint to img only.
//
// Replaces: depthinspace_tpu/ops/pallas/warp2d_v2.py::_v2_bwd (the Pallas
// body _bwd_kernel) and depthinspace_tpu/ops/pallas/warp_kernel.py's
// backward of warp2d (K5, reached through ops/resample.py::warp2d_v1).
// CPU truth: ops/resample.py::warp2d_bwd_plain (the flow is data and gets
// no gradient).
//
//   grad_img[corner c of p] += w_c(p) * g(p)   for each VALID corner c
//
// with the forward's weights and validity (taps_at: the same clamp before
// the int conversion, no +-max_shift bound), into an output that the
// launcher zeroes first. Any flow is right, NaN and huge ones included: a
// corner outside the image adds nothing.
//
// What bounds it on the H100: bytes (flow 8, g 4 and the output 4 a pixel
// at C = 1), and the float atomics that a scatter needs. The first design
// (warp2d_bwd_kernel, below; the path for C > 8) runs one thread a pixel on
// (128-pixel chunks of a row, rows, images) and adds each of its four
// corners with a float atomicAdd into global memory: 4 L2 atomics a pixel
// and channel. At (96, 512, 432, 1) it ran at 36 % of the byte bound.
//
// The strip kernel (warp2d_bwd_strip_kernel, the path for C = 1..8): a warp
// takes 32 consecutive columns and each lane a strip of V = 4 rows, the
// flow read as float2, C a template parameter. For the smooth flows of
// the geometric losses most corners are shared: a pixel's bottom corners
// are the top corners of the pixel below it, and its right corners the
// left corners of its right neighbour. The kernel merges them in
// registers, down each strip and then across lanes with warp shuffles, so
// that each cell is added once per warp and strip: ~1.3 atomics a pixel in
// place of 4, issued as fire-and-forget RED on consecutive addresses.
// Cells that do not coincide (steps in the flow, random or huge flows) are
// simply added apart, so any flow is right and only the speed depends on
// its smoothness. On the H100 (scripts/ab_torch_kernels.py) its time at
// (96, 512, 432, 1) splits into the zeroing (15 %), the loads (40 %; they
// alone stream at ~3 TB/s), the arithmetic (21 %) and the atomics (26 %).
//
// A third design, a block's tile of pixels adding its corners into a
// shared-memory window that is flushed once with coalesced (float4)
// global atomics (warp2d_bwd_tile_kernel), lost even to the first design: sm_90a compiles a float atomicAdd on shared memory to a
// compare-and-swap loop (ATOMS.CAST.SPIN), and the window's four shared
// adds a pixel cost more than the global REDs they save, even with the
// strips' corners merged first. It is built only with -DDIS_AB_VARIANTS.
// Neither kernel is reproducible bit for bit: float atomics sum a cell's
// contributions in an order that varies from run to run.
__global__ void warp2d_bwd_kernel(const float* __restrict__ flow,
                                  const float* __restrict__ g,
                                  float* __restrict__ grad, int H, int W,
                                  int C) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= W) return;
  const int v = blockIdx.y;
  const long long m = blockIdx.z;
  const long long p = (m * H + v) * W + u;
  const Taps t = taps_at(flow[2 * p], flow[2 * p + 1], u, v, H, W);

  float* base = grad + m * H * (long long)W * C;
  const float* gp = g + p * C;
  const int cx[4] = {t.cx0, t.cx1, t.cx0, t.cx1};
  const int cy[4] = {t.cy0, t.cy0, t.cy1, t.cy1};
  for (int c = 0; c < C; ++c) {
    const float gc = gp[c];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (t.valid[q])
        atomicAdd(base + ((long long)cy[q] * W + cx[q]) * C + c,
                  __fmul_rn(gc, t.w[q]));
  }
}

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;

// The corner contributions of a strip of V vertically consecutive pixels of
// one column: each pixel's top-left corner (x0, y0), clamped into
// [-2, W+1] x [-2, H+1] as taps_at clamps it, its corner q at
// (x0 + (q & 1), y0 + (q >> 1)), and which corners the thread still adds.
template <int C, int V>
struct Strip {
  int x0[V], y0[V];
  unsigned emit[V];     // bit q: this thread adds corner q (valid, not merged)
  float val[V][4][C];   // w_q * g, or the sum of the corners merged into it
};

// Loads the flows and g of the strip at column u, rows v0 .. v0 + V-1 of
// image plane `plane` (m * H), streamed (evict-first); pixels outside the
// image add nothing.
template <int C, int V>
__device__ __forceinline__ void strip_load(const float* __restrict__ flow,
                                           const float* __restrict__ g,
                                           long long plane, int u, int v0,
                                           int H, int W, float2 (&f)[V],
                                           float (&gv)[V][C], bool (&in)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    in[i] = u < W && v0 + i < H;
    const long long p = (plane + v0 + i) * W + u;
    f[i] = in[i] ? __ldcs(reinterpret_cast<const float2*>(flow) + p)
                 : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int c = 0; c < C; ++c) gv[i][c] = in[i] ? __ldcs(g + p * C + c) : 0.0f;
  }
}

// The strip's corners, with the forward's weights and validity (taps_at's
// arithmetic; w_q * g rounded as the plain version rounds the product),
// then a pixel's bottom corners merged with the top corners of the pixel
// below it where they are one cell, as they are for smooth flows. Only
// corners that both still add are merged.
template <int C, int V>
__device__ __forceinline__ void strip_taps(const float2 (&f)[V],
                                           const float (&gv)[V][C],
                                           const bool (&in)[V], int u, int v0,
                                           int H, int W, Strip<C, V>& s) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float gx = __fadd_rn(f[i].x, (float)u);
    const float gy = __fadd_rn(f[i].y, (float)(v0 + i));
    const float x0f = floorf(gx);
    const float y0f = floorf(gy);
    const float wx1 = __fsub_rn(gx, x0f);
    const float wy1 = __fsub_rn(gy, y0f);
    const float wx0 = __fsub_rn(1.0f, wx1);
    const float wy0 = __fsub_rn(1.0f, wy1);
    const float w[4] = {__fmul_rn(wy0, wx0), __fmul_rn(wy0, wx1),
                        __fmul_rn(wy1, wx0), __fmul_rn(wy1, wx1)};
    const int x0 = (int)fminf(fmaxf(x0f, -2.0f), (float)(W + 1));
    const int y0 = (int)fminf(fmaxf(y0f, -2.0f), (float)(H + 1));
    const unsigned vx = ((unsigned)x0 < (unsigned)W) |
                        ((unsigned)(x0 + 1) < (unsigned)W) << 1;
    const unsigned vy = ((unsigned)y0 < (unsigned)H) |
                        ((unsigned)(y0 + 1) < (unsigned)H) << 1;
    s.x0[i] = x0;
    s.y0[i] = y0;
    // corner q = (row bit 1, column bit 0) is valid where both are
    s.emit[i] = in[i] ? (vx * (vy & 1)) | (vx * (vy >> 1)) << 2 : 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < C; ++c) s.val[i][q][c] = __fmul_rn(gv[i][c], w[q]);
  }
#pragma unroll
  for (int i = 0; i + 1 < V; ++i) {
    // bit 0: this pixel's corner 2 and the next one's corner 0; bit 1:
    // corners 3 and 1
    const unsigned m = s.x0[i] == s.x0[i + 1] && s.y0[i] + 1 == s.y0[i + 1]
                           ? s.emit[i] >> 2 & s.emit[i + 1] & 3u
                           : 0u;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (m >> h & 1)
#pragma unroll
        for (int c = 0; c < C; ++c)
          s.val[i][2 + h][c] = __fadd_rn(s.val[i][2 + h][c],
                                         s.val[i + 1][h][c]);
    s.emit[i + 1] &= ~m;
  }
}

// The corner key y0 * (W + 4) + x0: the pixel to the right shares its
// left corners with this pixel's right ones iff its key is one more
// ((H + 2) * (W + 4) < 2^31).
__device__ __forceinline__ int corner_key(int x0, int y0, int W) {
  return y0 * (W + 4) + x0;
}

// Row i of strip s takes the left corners of the pixel to its right (key
// nkey, corners nemit, values n0 and n2 of its corners 0 and 2) into its
// right corners where they are one cell and both still add; returns the
// corners the right pixel no longer adds (bits 0 and 2).
template <int C, int V>
__device__ __forceinline__ unsigned take_right(Strip<C, V>& s, int i, int W,
                                               int nkey, unsigned nemit,
                                               const float (&n0)[C],
                                               const float (&n2)[C]) {
  // bit 0: this pixel's corner 1 and the neighbour's corner 0; bit 2:
  // corners 3 and 2
  const unsigned m = nkey == corner_key(s.x0[i], s.y0[i], W) + 1
                         ? s.emit[i] >> 1 & nemit & 5u
                         : 0u;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (m & 1) s.val[i][1][c] = __fadd_rn(s.val[i][1][c], n0[c]);
    if (m & 4) s.val[i][3][c] = __fadd_rn(s.val[i][3][c], n2[c]);
  }
  return m;
}

// The same across lanes: each row of `left` (this lane) takes the left
// corners of the same row of `right` in lane + 1, which no longer adds
// them (lane 31 has no right neighbour in the warp).
template <int C, int V>
__device__ __forceinline__ void merge_lanes(Strip<C, V>& left,
                                            Strip<C, V>& right, int W) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int nkey = __shfl_down_sync(
        0xffffffffu, corner_key(right.x0[i], right.y0[i], W), 1);
    const unsigned nemit = __shfl_down_sync(0xffffffffu, right.emit[i], 1);
    float n0[C], n2[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      n0[c] = __shfl_down_sync(0xffffffffu, right.val[i][0][c], 1);
      n2[c] = __shfl_down_sync(0xffffffffu, right.val[i][2][c], 1);
    }
    const unsigned m =
        lane < 31 ? take_right(left, i, W, nkey, nemit, n0, n2) : 0u;
    const unsigned taken = __shfl_up_sync(0xffffffffu, m, 1);
    if (lane > 0) right.emit[i] &= ~taken;
  }
}

// The strip kernel: a warp takes 32 consecutive columns, each lane a strip
// of V rows, 8 warps stacked on 8 * V rows. The strips' corners are merged
// in registers (down each strip, then across lanes by warp shuffles) and
// added straight into the zeroed output with global atomics
// (fire-and-forget RED, a row's corners on consecutive addresses across
// the lanes). DRY is for timing its parts (scripts/ab_torch_kernels.py):
// 1 skips the atomics, 2 also the arithmetic; a store that never happens
// keeps the rest alive.
template <int C, int V, int DRY = 0>
__global__ void __launch_bounds__(kBwdThreads)
    warp2d_bwd_strip_kernel(const float* __restrict__ flow,
                            const float* __restrict__ g,
                            float* __restrict__ grad, int H, int W) {
  const int u = blockIdx.x * 32 + (threadIdx.x & 31);
  const int v0 = (blockIdx.y * kBwdWarps + (threadIdx.x >> 5)) * V;
  const long long plane = (long long)blockIdx.z * H;
  float2 f[V];
  float gv[V][C];
  bool in[V];
  strip_load<C, V>(flow, g, plane, u, v0, H, W, f, gv, in);
  float dry = 0.0f;
  if constexpr (DRY == 2) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      dry += f[i].x + f[i].y;
#pragma unroll
      for (int c = 0; c < C; ++c) dry += gv[i][c];
    }
  } else {
    Strip<C, V> s;
    strip_taps<C, V>(f, gv, in, u, v0, H, W, s);
    merge_lanes<C, V>(s, s, W);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (!s.emit[i]) continue;
      float* base = grad + ((plane + s.y0[i]) * W + s.x0[i]) * C;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (s.emit[i] >> q & 1) {
          float* dst = base + ((q >> 1) * W + (q & 1)) * C;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            if constexpr (DRY == 1)
              dry += s.val[i][q][c] + (float)(dst - grad);
            else
              atomicAdd(dst + c, s.val[i][q][c]);
          }
        }
    }
  }
  if (DRY && dry == -1.0e38f) grad[0] = dry;
}

#ifdef DIS_AB_VARIANTS
// Built only for scripts/ab_torch_kernels.py (-DDIS_AB_VARIANTS): the
// shared-memory window design, which lost to the first design and to the
// strip kernel (the shared float atomics are compare-and-swap loops).
constexpr int kBwdTileW = 64;

// the window's cells: at most 4096, in the 48 KB of static shared memory
// less the box's slots
__host__ __device__ constexpr int bwd_cells(int C) {
  return 12224 / C < 4096 ? 12224 / C : 4096;
}
// the window's columns are aligned to this many so that a row of C-channel
// cells starts on 16 bytes (VEC)
__host__ __device__ constexpr int bwd_align(int C) {
  return C % 4 == 0 ? 1 : C % 2 == 0 ? 2 : 4;
}
// the widest margin (up to 16) by which the tile's own window, its cells
// (tile + 1 corner), grows in every direction and still fits
__host__ __device__ constexpr int bwd_margin(int rows, int C,
                                              int align) {
  int r = 16;
  while (r > 0 && (rows + 1 + 2 * r) * (kBwdTileW + 1 + 2 * r +
                                        2 * (align - 1)) > bwd_cells(C))
    --r;
  return r;
}

// The tile kernel: a block owns a tile of 8*RPW rows x 64 columns (lane l
// of warp w: strips of RPW rows at columns l and l + 32), adds the strips'
// merged corners that fall inside its window with shared-memory atomics
// and the others with global ones, then flushes the window once.
template <int C, int RPW, bool VEC>
__global__ void __launch_bounds__(kBwdThreads)
    warp2d_bwd_tile_kernel(const float* __restrict__ flow,
                           const float* __restrict__ g,
                           float* __restrict__ grad, int H, int W) {
  constexpr int TH = kBwdWarps * RPW;          // tile rows
  constexpr int kCells = bwd_cells(C);
  constexpr int A = VEC ? bwd_align(C) : 1;
  constexpr int R = bwd_margin(TH, C, A);
  static_assert((TH + 1) * (kBwdTileW + 1 + 2 * (A - 1)) <= kCells,
                "the tile's own window must fit in shared memory");
  __shared__ __align__(16) float win[kCells * C];
  __shared__ int wbox[kBwdWarps][4];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int u0 = blockIdx.x * kBwdTileW;
  const int v0 = blockIdx.y * TH;
  const int vs = v0 + RPW * warp;                       // the strips' row
  const long long plane = (long long)blockIdx.z * H;   // m * H

  float2 f[2][RPW];
  float gv[2][RPW][C];
  bool in[2][RPW];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    strip_load<C, RPW>(flow, g, plane, u0 + lane + 32 * j, vs, H, W, f[j],
                       gv[j], in[j]);
  Strip<C, RPW> s[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    strip_taps<C, RPW>(f[j], gv[j], in[j], u0 + lane + 32 * j, vs, H, W,
                       s[j]);
    merge_lanes<C, RPW>(s[j], s[j], W);
  }

  // the box of the corners the block adds (inclusive)
  int bx0 = INT_MAX, by0 = INT_MAX, bx1 = INT_MIN, by1 = INT_MIN;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (s[j].emit[i] >> q & 1) {
          const int x = s[j].x0[i] + (q & 1);
          const int y = s[j].y0[i] + (q >> 1);
          bx0 = min(bx0, x);
          bx1 = max(bx1, x);
          by0 = min(by0, y);
          by1 = max(by1, y);
        }
  bx0 = __reduce_min_sync(0xffffffffu, bx0);
  by0 = __reduce_min_sync(0xffffffffu, by0);
  bx1 = __reduce_max_sync(0xffffffffu, bx1);
  by1 = __reduce_max_sync(0xffffffffu, by1);
  if (lane == 0) {
    wbox[warp][0] = bx0;
    wbox[warp][1] = by0;
    wbox[warp][2] = bx1;
    wbox[warp][3] = by1;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kBwdWarps; ++i) {
    bx0 = min(bx0, wbox[i][0]);
    by0 = min(by0, wbox[i][1]);
    bx1 = max(bx1, wbox[i][2]);
    by1 = max(by1, wbox[i][3]);
  }

  // the window [wx0, wx1) x [wy0, wy1): the box where it fits, else the
  // tile grown by R; its columns aligned to A (W is a multiple of A)
  int wx0 = 0, wx1 = 0, wy0 = 0, wy1 = 0;
  if (bx0 <= bx1) {
    wx0 = bx0 / A * A;
    wx1 = (bx1 + A) / A * A;
    wy0 = by0;
    wy1 = by1 + 1;
    if ((long long)(wx1 - wx0) * (wy1 - wy0) > kCells) {
      wx0 = max(u0 - R, 0) / A * A;
      wx1 = (min(u0 + kBwdTileW + 1 + R, W) + A - 1) / A * A;
      wy0 = max(v0 - R, 0);
      wy1 = min(v0 + TH + 1 + R, H);
    }
  }
  const int ww = wx1 - wx0;
  const int wh = wy1 - wy0;
  const int rowlen = ww * C;
  const int total = wh * rowlen;
  for (int i = threadIdx.x; i < total; i += kBwdThreads) win[i] = 0.0f;
  __syncthreads();

#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!(s[j].emit[i] >> q & 1)) continue;
        const int x = s[j].x0[i] + (q & 1);
        const int y = s[j].y0[i] + (q >> 1);
        const int xi = x - wx0;
        const int yi = y - wy0;
        if ((unsigned)xi < (unsigned)ww && (unsigned)yi < (unsigned)wh) {
          float* dst = win + (yi * ww + xi) * C;
#pragma unroll
          for (int c = 0; c < C; ++c) atomicAdd(dst + c, s[j].val[i][q][c]);
        } else {
          float* dst = grad + ((plane + y) * W + x) * C;
#pragma unroll
          for (int c = 0; c < C; ++c) atomicAdd(dst + c, s[j].val[i][q][c]);
        }
      }
  __syncthreads();

  if (total == 0) return;
  float* out = grad + ((plane + wy0) * W + wx0) * C;
  const long long pitch = (long long)W * C;
  if constexpr (VEC) {
    for (int i = 4 * threadIdx.x; i < total; i += 4 * kBwdThreads) {
      const float4 v = *reinterpret_cast<const float4*>(win + i);
      if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f) {
        const int r = i / rowlen;
        atomicAdd(reinterpret_cast<float4*>(out + r * pitch + (i - r * rowlen)),
                  v);
      }
    }
  } else {
    for (int i = threadIdx.x; i < total; i += kBwdThreads) {
      const float v = win[i];
      if (v != 0.0f) {
        const int r = i / rowlen;
        atomicAdd(out + r * pitch + (i - r * rowlen), v);
      }
    }
  }
}

template <int C, int RPW>
int bwd_tile(const float* flow, const float* g, float* grad, int M, int H,
             int W, bool vec, cudaStream_t s) {
  constexpr int TH = kBwdWarps * RPW;
  const dim3 grid((W + kBwdTileW - 1) / kBwdTileW, (H + TH - 1) / TH, M);
  if (vec)
    warp2d_bwd_tile_kernel<C, RPW, true>
        <<<grid, kBwdThreads, 0, s>>>(flow, g, grad, H, W);
  else
    warp2d_bwd_tile_kernel<C, RPW, false>
        <<<grid, kBwdThreads, 0, s>>>(flow, g, grad, H, W);
  return (int)cudaGetLastError();
}

#endif

// the strip kernel's rows a lane
constexpr int kBwdStripV = 4;

template <int C, int V, int DRY = 0>
int bwd_strip(const float* flow, const float* g, float* grad, int M, int H,
              int W, cudaStream_t s) {
  const dim3 grid((W + 31) / 32, (H + kBwdWarps * V - 1) / (kBwdWarps * V),
                  M);
  warp2d_bwd_strip_kernel<C, V, DRY>
      <<<grid, kBwdThreads, 0, s>>>(flow, g, grad, H, W);
  return (int)cudaGetLastError();
}

template <int C>
int bwd_c(const float* flow, const float* g, float* grad, int M, int H,
          int W, int path, int rows, cudaStream_t s) {
#ifdef DIS_AB_VARIANTS
  if (path >= 2) {
    if (C == 1 && rows == 1)
      return bwd_tile<1, 1>(flow, g, grad, M, H, W, path == 2, s);
    if (rows != 2) return (int)cudaErrorInvalidValue;
    return bwd_tile<C, 2>(flow, g, grad, M, H, W, path == 2, s);
  }
  if (C == 1 && rows == 1) return bwd_strip<1, 1>(flow, g, grad, M, H, W, s);
  if (C == 1 && rows == 2) return bwd_strip<1, 2>(flow, g, grad, M, H, W, s);
  if (C == 1 && rows == 8) return bwd_strip<1, 8>(flow, g, grad, M, H, W, s);
#endif
  if (path != 1 || rows != kBwdStripV) return (int)cudaErrorInvalidValue;
  return bwd_strip<C, kBwdStripV>(flow, g, grad, M, H, W, s);
}

// Zeroes grad (parts & 1), then scatters (parts & 2). path 0: the first
// design (any C); 1: the strip kernel (C = 1..8) with kBwdStripV rows a
// lane. Only with -DDIS_AB_VARIANTS: path 1 with rows = 1, 2 or 8 at C = 1;
// path 2 and 3, the tile kernel with a float4 and a scalar flush, rows = 2
// rows a warp (or 1 at C = 1); and the strip kernel's scatter without its
// atomics (parts & 4) or also without its arithmetic (parts & 8).
int bwd(const float* flow, const float* g, float* grad, int M, int H, int W,
        int C, int path, int rows, int parts, cudaStream_t s) {
#ifdef DIS_AB_VARIANTS
  if (path < 0 || path > 3) return (int)cudaErrorInvalidValue;
  if (path == 2 && W % bwd_align(C)) return (int)cudaErrorInvalidValue;
#else
  if (path < 0 || path > 1) return (int)cudaErrorInvalidValue;
#endif
  if (path > 0 && !(C >= 1 && C <= 8)) return (int)cudaErrorInvalidValue;
  if (parts & 1) {
    const cudaError_t err = cudaMemsetAsync(
        grad, 0, sizeof(float) * (size_t)M * H * W * C, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (!(parts & 2)) return 0;
#ifdef DIS_AB_VARIANTS
  if (parts & 12) {
    if (path != 1 || C != 1 || rows != kBwdStripV)
      return (int)cudaErrorInvalidValue;
    return parts & 8 ? bwd_strip<1, kBwdStripV, 2>(flow, g, grad, M, H, W, s)
                     : bwd_strip<1, kBwdStripV, 1>(flow, g, grad, M, H, W, s);
  }
#endif
  if (path == 0) {
    const dim3 grid((W + 127) / 128, H, M);
    warp2d_bwd_kernel<<<grid, 128, 0, s>>>(flow, g, grad, H, W, C);
    return (int)cudaGetLastError();
  }
  switch (C) {
    case 1: return bwd_c<1>(flow, g, grad, M, H, W, path, rows, s);
    case 2: return bwd_c<2>(flow, g, grad, M, H, W, path, rows, s);
    case 3: return bwd_c<3>(flow, g, grad, M, H, W, path, rows, s);
    case 4: return bwd_c<4>(flow, g, grad, M, H, W, path, rows, s);
    case 5: return bwd_c<5>(flow, g, grad, M, H, W, path, rows, s);
    case 6: return bwd_c<6>(flow, g, grad, M, H, W, path, rows, s);
    case 7: return bwd_c<7>(flow, g, grad, M, H, W, path, rows, s);
    case 8: return bwd_c<8>(flow, g, grad, M, H, W, path, rows, s);
    default: return (int)cudaErrorInvalidValue;
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

// flow: contiguous (M, H, W, 2) float32, 8-byte aligned for path 1; g,
// grad: contiguous (M, H, W, C) float32. Zeroes grad on the stream, then
// scatters: path 0 the first design (any C), 1 the strip kernel (C in
// 1..8). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a path or C that it does not take.
extern "C" int dis_warp2d_bwd(const float* flow, const float* g, float* grad,
                              int M, int H, int W, int C, int path,
                              void* stream) {
  return bwd(flow, g, grad, M, H, W, C, path, kBwdStripV, 3,
             (cudaStream_t)stream);
}

#ifdef DIS_AB_VARIANTS
// dis_warp2d_bwd with the variants that lost and the parts given (see bwd):
// path 2 and 3 (the tile kernel), rows, and parts (3: the whole call; 1:
// the zeroing alone; 2: the scatter alone; 6: the strip kernel's scatter
// without its atomics).
extern "C" int dis_ab_warp2d_bwd(const float* flow, const float* g,
                                 float* grad, int M, int H, int W, int C,
                                 int path, int rows, int parts,
                                 void* stream) {
  return bwd(flow, g, grad, M, H, W, C, path, rows, parts,
             (cudaStream_t)stream);
}
#endif
