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

#include "round_fixed.cuh"

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
// for C = 1 (their outputs stored as one float2).
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

// Order-independent sums for the backward below: each contribution is added
// as an integer, so the result has the same bits whatever order the threads
// add in. The Pallas backward of depthinspace_tpu/ops/pallas/warp2d_v2.py
// accumulates each band in a VMEM block that the grid revisits in a fixed
// order, so the TPU gives one result for one input. On the card many blocks
// add into one cell at once; float atomics would sum a cell's terms in
// whatever order they arrive, and the rounding of a sum of three or more
// terms depends on that order.
//
// The scheme (fixed point in two 64-bit words a cell):
//   - one pass finds G, the largest finite |g| of the call (an integer
//     atomicMax on the float's bits, which is order-independent), so that
//     every term w * g (0 <= w <= 1) is below 2^eG, eG the exponent bound
//     of G;
//   - the caller bounds P, the terms any one cell can receive (a pixel
//     adds to a cell at most once), by 2^c. Then every cell's sum is below
//     2^(eG + c);
//   - the unit is u = 2^(eG - 123 + 2c): a term t is the integer
//     V = round(t / u) < 2^(123 - 2c), split as V = H * 2^k + L with
//     0 <= L < 2^k, k = 61 - c. A cell adds the H of its terms into a
//     signed 64-bit word (|sum| < 2^62 + 2^c) and the L into an unsigned one
//     (sum < 2^61), both with 64-bit integer atomics (RED.ADD.64). The top
//     three bits of the unsigned word flag NaN, +inf and -inf terms
//     (atomicOr), so a non-finite g propagates as a float sum would;
//   - a last pass forms H * 2^k + L as a 128-bit integer and rounds it
//     times u once to float32 (round_fixed.cuh).
// A term loses only what lies below u, at most 2^(2c - 122) of G: 2^-86 at
// the main paths' shapes (c = 18), so each cell is its exact sum rounded
// once to float32, however its terms' magnitudes spread, closer than a
// float32 sum in any fixed order gets.
//
// What it costs on the H100: a cell is 16 bytes of scratch (zeroed, then
// read once more by the last pass) in place of 4, a term two 64-bit integer
// atomics in place of one float atomic (sm_90 has vector atomics for floats
// only), and one read of g for G.

namespace fixed_sum {

constexpr unsigned long long kNaN = 1ull << 61;
constexpr unsigned long long kPosInf = 1ull << 62;
constexpr unsigned long long kNegInf = 1ull << 63;
constexpr unsigned long long kLowBits = kNaN - 1;

// The call's scale: u = 2^lg, a term's low part k bits.
struct Scale {
  int lg;
  int k;
};

// From the bits of G (the largest finite |g|, 0 when there is none) and c.
__device__ __forceinline__ Scale scale_of(unsigned gbits, int c) {
  const int e = (int)(gbits >> 23);
  const int eG = e == 0 ? -126 : e - 126;  // G < 2^eG
  return Scale{eG - 123 + 2 * c, 61 - c};
}

// Adds the float t into the cell (lo, hi) at cell[0], cell[1].
__device__ __forceinline__ void add(unsigned long long* cell, float t,
                                    Scale s) {
  const unsigned b = __float_as_uint(t);
  const unsigned ex = (b >> 23) & 0xffu;
  if (ex == 0xffu) {
    atomicOr(cell, (b & 0x7fffffu) ? kNaN : (b >> 31) ? kNegInf : kPosInf);
    return;
  }
  // t = m * 2^e exactly, |m| < 2^24
  long long m = ex ? (long long)((b & 0x7fffffu) | 0x800000u)
                   : (long long)(b & 0x7fffffu);
  if (m == 0) return;
  if (b >> 31) m = -m;
  const int d = (ex ? (int)ex - 150 : -149) - s.lg;  // t / u = m * 2^d
  long long hi;
  unsigned long long lo;
  const unsigned long long mask = (1ull << s.k) - 1;
  if (d >= s.k) {
    hi = (long long)((unsigned long long)m << (d - s.k));
    lo = 0;
  } else if (d >= 0) {
    hi = m >> (s.k - d);  // floor
    lo = ((unsigned long long)m << d) & mask;
  } else {
    const int sh = -d;  // round half up to an integer number of units
    const long long r = sh > 62 ? 0 : (m + (1ll << (sh - 1))) >> sh;
    hi = r < 0 ? -1 : 0;
    lo = (unsigned long long)r & mask;
  }
  if (lo) atomicAdd(cell, lo);
  if (hi) atomicAdd(cell + 1, (unsigned long long)hi);
}

// The cell's sum, rounded to float32.
__device__ __forceinline__ float value(ulonglong2 cell, Scale s) {
  const unsigned long long flags = cell.x & ~kLowBits;
  if (flags) {
    const bool nan = (flags & kNaN) || ((flags & kPosInf) && (flags & kNegInf));
    return nan ? __int_as_float(0x7fc00000)
               : (flags & kPosInf) ? __int_as_float(0x7f800000)
                                   : __int_as_float(0xff800000);
  }
  const unsigned long long low = cell.x & kLowBits;
  const long long hi = (long long)cell.y + (long long)(low >> s.k);
  const unsigned long long lo = low & ((1ull << s.k) - 1);
  // hi * 2^k + lo in 128-bit two's complement
  const unsigned __int128 n =
      ((unsigned __int128)(__int128)hi << s.k) + lo;
  const bool neg = hi < 0;
  return round_fixed(neg ? (unsigned __int128)0 - n : n, neg, s.lg);
}

// An adder of float terms into element i of a fixed-point scratch.
struct Adder {
  unsigned long long* acc;
  Scale s;
  __device__ __forceinline__ void operator()(long long i, float v) const {
    add(acc + 2 * i, v, s);
  }
};

// What a scatter kernel receives: the scratch, G's bits (written by the
// absmax pass before it) and c; bind() reads the scale once a thread.
struct Sink {
  unsigned long long* acc;
  const unsigned* gbits;
  int c;
  __device__ __forceinline__ Adder bind() const {
    return Adder{acc, scale_of(*gbits, c)};
  }
};

// |v|'s bits, or 0 for a non-finite v.
__device__ __forceinline__ unsigned finite_abs(unsigned b) {
  b &= 0x7fffffffu;
  return b < 0x7f800000u ? b : 0u;
}

// G's bits into *out (zeroed before): the elements before the first 16-byte
// boundary and after the last one alone, the rest as 16-byte loads.
__global__ void __launch_bounds__(256)
    absmax_kernel(const float* __restrict__ g, long long n, long long head,
                  unsigned* __restrict__ out) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long nv = (n - head) / 4;
  unsigned m = 0;
  const uint4* v = reinterpret_cast<const uint4*>(g + head);
  for (long long i = tid; i < nv; i += stride) {
    const uint4 w = __ldcs(v + i);
    m = max(m, max(max(finite_abs(w.x), finite_abs(w.y)),
                   max(finite_abs(w.z), finite_abs(w.w))));
  }
  for (long long i = tid; i < head; i += stride)
    m = max(m, finite_abs(__float_as_uint(g[i])));
  for (long long i = head + nv * 4 + tid; i < n; i += stride)
    m = max(m, finite_abs(__float_as_uint(g[i])));
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0 && m) atomicMax(out, m);
}

// Every element of out from its cell: out is written whole.
__global__ void __launch_bounds__(256)
    value_kernel(const ulonglong2* __restrict__ acc,
                 const unsigned* __restrict__ gbits, int c,
                 float* __restrict__ out, long long n) {
  const Scale s = scale_of(*gbits, c);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = value(__ldcs(acc + i), s);
}

inline int blocks_for(long long items) {
  const long long want = items / 256 + 1;
  return (int)(want < 132 * 16 ? want : 132 * 16);
}

// The passes of one call on n cells of out (and of g), scratch acc: 2n + 2
// words, 16-byte aligned (the n cells, then G's bits).
inline int zero(unsigned long long* acc, long long n, cudaStream_t s) {
  return (int)cudaMemsetAsync(acc, 0, sizeof(unsigned long long) * (2 * n + 2),
                              s);
}

inline unsigned* gbits_of(unsigned long long* acc, long long n) {
  return reinterpret_cast<unsigned*>(acc + 2 * n);
}

int find_max(const float* g, unsigned long long* acc, long long n,
             cudaStream_t s) {
  if (n <= 0) return 0;
  const long long mis = (long long)(reinterpret_cast<size_t>(g) & 15);
  long long head = ((16 - mis) & 15) / 4;
  if (head > n) head = n;
  absmax_kernel<<<blocks_for((n - head) / 4), 256, 0, s>>>(
      g, n, head, gbits_of(acc, n));
  return (int)cudaGetLastError();
}

int write_out(const unsigned long long* acc, int c, float* out, long long n,
              cudaStream_t s) {
  if (n <= 0) return 0;
  value_kernel<<<blocks_for(n), 256, 0, s>>>(
      reinterpret_cast<const ulonglong2*>(acc),
      reinterpret_cast<const unsigned*>(acc + 2 * n), c, out, n);
  return (int)cudaGetLastError();
}

}  // namespace fixed_sum

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
// the int conversion, no +-max_shift bound). Any flow is right, NaN and
// huge ones included: a corner outside the image adds nothing.
//
// One input gives one result: the terms are added as integers (fixed_sum,
// above), so the order in which the threads add does not matter,
// as the TPU kernel's fixed grid order makes its sums repeat. A call is
// four passes: the fixed-point scratch (16 bytes a cell) is zeroed, one
// pass finds the largest |g|, the scatter adds each term with two 64-bit
// integer atomics, and the last pass writes every element of grad.
//
// What bounds it on the H100: bytes (flow 8, g 4 and the output 4 a pixel
// at C = 1, read and written once) and the scatter's atomics. The scatter
// is the strip kernel (the path for C = 1..8): a warp takes 32 consecutive
// columns and each lane a strip of V = 4 rows, the flow read as float2, C a
// template parameter. For the smooth flows of the geometric losses most
// corners are shared: a pixel's bottom corners are the top corners of the
// pixel below it, and its right corners the left corners of its right
// neighbour. The kernel merges them in registers, down each strip and then
// across lanes with warp shuffles, so that each cell is added once per warp
// and strip: ~1.3 adds a pixel in place of 4. The merges sum in an order
// fixed by the pixels' places, so they keep the result deterministic.
// Cells that do not coincide (steps in the flow, random or huge flows) are
// simply added apart, so any flow is right and only the speed depends on
// its smoothness. The first design (warp2d_bwd_kernel, the path for C > 8
// or an unaligned flow) runs one thread a pixel and adds all four corners.
//
// The strip kernel with float atomics, which this design replaced (one float
// RED a merged corner into a zeroed float32 grad, its sums in a varying
// order), is built only with -DDIS_AB_VARIANTS, to time beside this one. A
// shared-memory window design lost to it earlier: sm_90a compiles a float
// atomicAdd on shared memory to a compare-and-swap loop (ATOMS.CAST.SPIN).

// The first design: one thread a pixel on (128-pixel chunks of a row, rows,
// images), every valid corner of every channel added apart.
__global__ void warp2d_bwd_kernel(const float* __restrict__ flow,
                                  const float* __restrict__ g,
                                  fixed_sum::Sink sink, int H, int W, int C) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= W) return;
  const int v = blockIdx.y;
  const long long m = blockIdx.z;
  const long long p = (m * H + v) * W + u;
  const Taps t = taps_at(flow[2 * p], flow[2 * p + 1], u, v, H, W);
  const fixed_sum::Adder add = sink.bind();

  const long long base = m * H * (long long)W;
  const float* gp = g + p * C;
  const int cx[4] = {t.cx0, t.cx1, t.cx0, t.cx1};
  const int cy[4] = {t.cy0, t.cy0, t.cy1, t.cy1};
  for (int c = 0; c < C; ++c) {
    const float gc = gp[c];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (t.valid[q])
        add((base + (long long)cy[q] * W + cx[q]) * C + c,
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

// Each row of strip s (this lane) takes the left corners of the same row in
// lane + 1 into its right corners where they are one cell and both still
// add; lane + 1 then no longer adds them (lane 31 has no right neighbour in
// the warp).
template <int C, int V>
__device__ __forceinline__ void merge_lanes(Strip<C, V>& s, int W) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int nkey = __shfl_down_sync(
        0xffffffffu, corner_key(s.x0[i], s.y0[i], W), 1);
    const unsigned nemit = __shfl_down_sync(0xffffffffu, s.emit[i], 1);
    float n0[C], n2[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      n0[c] = __shfl_down_sync(0xffffffffu, s.val[i][0][c], 1);
      n2[c] = __shfl_down_sync(0xffffffffu, s.val[i][2][c], 1);
    }
    // bit 0: this pixel's corner 1 and the neighbour's corner 0; bit 2:
    // corners 3 and 2
    const unsigned m = lane < 31 && nkey == corner_key(s.x0[i], s.y0[i], W) + 1
                           ? s.emit[i] >> 1 & nemit & 5u
                           : 0u;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (m & 1) s.val[i][1][c] = __fadd_rn(s.val[i][1][c], n0[c]);
      if (m & 4) s.val[i][3][c] = __fadd_rn(s.val[i][3][c], n2[c]);
    }
    const unsigned taken = __shfl_up_sync(0xffffffffu, m, 1);
    if (lane > 0) s.emit[i] &= ~taken;
  }
}

// The strip kernel: a warp takes 32 consecutive columns, each lane a strip
// of V rows, 8 warps stacked on 8 * V rows. The strips' corners are merged
// in registers (down each strip, then across lanes by warp shuffles) and
// each remaining corner is added once through the sink (a row's corners on
// consecutive cells across the lanes). Sink is fixed_sum::Sink; with
// -DDIS_AB_VARIANTS also FloatSink, the float atomics it replaced.
template <int C, int V, typename Sink>
__global__ void __launch_bounds__(kBwdThreads)
    warp2d_bwd_strip_kernel(const float* __restrict__ flow,
                            const float* __restrict__ g, Sink sink, int H,
                            int W) {
  const int u = blockIdx.x * 32 + (threadIdx.x & 31);
  const int v0 = (blockIdx.y * kBwdWarps + (threadIdx.x >> 5)) * V;
  const long long plane = (long long)blockIdx.z * H;
  float2 f[V];
  float gv[V][C];
  bool in[V];
  strip_load<C, V>(flow, g, plane, u, v0, H, W, f, gv, in);
  Strip<C, V> s;
  strip_taps<C, V>(f, gv, in, u, v0, H, W, s);
  merge_lanes<C, V>(s, W);
  const auto add = sink.bind();
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (!s.emit[i]) continue;
    const long long base = ((plane + s.y0[i]) * W + s.x0[i]) * C;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (s.emit[i] >> q & 1) {
        const long long cell = base + ((q >> 1) * W + (q & 1)) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) add(cell + c, s.val[i][q][c]);
      }
  }
}

// the strip kernel's rows a lane
constexpr int kBwdStripV = 4;

template <int C, typename Sink>
int bwd_strip(const float* flow, const float* g, Sink sink, int M, int H,
              int W, cudaStream_t s) {
  const dim3 grid((W + 31) / 32,
                  (H + kBwdWarps * kBwdStripV - 1) / (kBwdWarps * kBwdStripV),
                  M);
  warp2d_bwd_strip_kernel<C, kBwdStripV, Sink>
      <<<grid, kBwdThreads, 0, s>>>(flow, g, sink, H, W);
  return (int)cudaGetLastError();
}

template <typename Sink>
int scatter(const float* flow, const float* g, Sink sink, int M, int H,
            int W, int C, cudaStream_t s) {
  switch (C) {
    case 1: return bwd_strip<1>(flow, g, sink, M, H, W, s);
    case 2: return bwd_strip<2>(flow, g, sink, M, H, W, s);
    case 3: return bwd_strip<3>(flow, g, sink, M, H, W, s);
    case 4: return bwd_strip<4>(flow, g, sink, M, H, W, s);
    case 5: return bwd_strip<5>(flow, g, sink, M, H, W, s);
    case 6: return bwd_strip<6>(flow, g, sink, M, H, W, s);
    case 7: return bwd_strip<7>(flow, g, sink, M, H, W, s);
    case 8: return bwd_strip<8>(flow, g, sink, M, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The passes of one call (fixed_sum): parts & 1 zeroes acc, & 2 finds
// the largest |g|, & 4 scatters (path 0: the first design, any C; 1: the
// strip kernel, C = 1..8), & 8 writes grad. c: log2 of a bound on the terms
// a cell receives (H * W <= 2^c).
int bwd(const float* flow, const float* g, float* grad,
        unsigned long long* acc, int M, int H, int W, int C, int path, int c,
        int parts, cudaStream_t s) {
  if (path < 0 || path > 1 || (path == 1 && !(C >= 1 && C <= 8)) || c < 1 ||
      c > 29)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)M * H * W * C;
  int err = 0;
  if (parts & 1) err = fixed_sum::zero(acc, n, s);
  if (!err && (parts & 2)) err = fixed_sum::find_max(g, acc, n, s);
  if (!err && (parts & 4)) {
    const fixed_sum::Sink sink{acc, fixed_sum::gbits_of(acc, n), c};
    if (path == 0) {
      const dim3 grid((W + 127) / 128, H, M);
      warp2d_bwd_kernel<<<grid, 128, 0, s>>>(flow, g, sink, H, W, C);
      err = (int)cudaGetLastError();
    } else {
      err = scatter(flow, g, sink, M, H, W, C, s);
    }
  }
  if (!err && (parts & 8)) err = fixed_sum::write_out(acc, c, grad, n, s);
  return err;
}

#ifdef DIS_AB_VARIANTS
// The strip kernel with float atomics, for the before-and-after timing only:
// RED.ADD.F32 into a float32 grad zeroed first; not reproducible.
struct FloatAdd {
  float* grad;
  __device__ __forceinline__ void operator()(long long i, float v) const {
    atomicAdd(grad + i, v);
  }
};
struct FloatSink {
  float* grad;
  __device__ __forceinline__ FloatAdd bind() const { return FloatAdd{grad}; }
};
#endif

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

// flow: contiguous (M, H, W, 2) float32, 8-byte aligned for path 1; g,
// grad: contiguous (M, H, W, C) float32, grad written whole; acc: the
// fixed-point scratch, 2 * M*H*W*C + 2 int64 words, 16-byte aligned; c:
// ceil(log2(H * W)) in 1..29. Path 0 scatters with the first design (any
// C), 1 with the strip kernel (C in 1..8). Returns the first CUDA error of
// its launches, or cudaErrorInvalidValue for a path, C or c that it does
// not take.
extern "C" int dis_warp2d_bwd(const float* flow, const float* g, float* grad,
                              void* acc, int M, int H, int W, int C, int path,
                              int c, void* stream) {
  return bwd(flow, g, grad, (unsigned long long*)acc, M, H, W, C, path, c, 15,
             (cudaStream_t)stream);
}

#ifdef DIS_AB_VARIANTS
// For the before-and-after timing (chip_smoke.py phase 3,
// scripts/ab_torch_kernels.py), built with -DDIS_AB_VARIANTS only:
// dis_warp2d_bwd with one part of the call alone (parts, as bwd takes them)
// or, with atomic = 1, the strip kernel with float atomics (C in 1..8): grad
// zeroed, then its float atomics (acc and c unused).
extern "C" int dis_ab_warp2d_bwd(const float* flow, const float* g,
                                 float* grad, void* acc, int M, int H, int W,
                                 int C, int path, int c, int atomic,
                                 int parts, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (!atomic)
    return bwd(flow, g, grad, (unsigned long long*)acc, M, H, W, C, path, c,
               parts, s);
  const cudaError_t err = cudaMemsetAsync(
      grad, 0, sizeof(float) * (size_t)M * H * W * C, s);
  if (err != cudaSuccess) return (int)err;
  return scatter(flow, g, FloatSink{grad}, M, H, W, C, s);
}
#endif
