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
// The backward adds w*g to the four valid corners of plane src[m], and
// takes any table with 0 <= src[m] < S (the wrapper checks it on the host;
// the TPU kernel's grid needed every source in the same number of pairs).
// One input gives one result, as the TPU kernel's fixed grid order makes
// its sums repeat: each cell reads the list of terms it receives and sums
// them as integers (the design is described above its kernels, below), so
// no float atomic sums in a varying order. The wrapper takes the scalar sum
// (one channel a thread) for C not a multiple of 4 or unaligned g
// (kernels.pairs_bwd_path).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "round_fixed.cuh"

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
  __device__ static void store4(float* p, const float (&f)[4]) {
    store(p, f);
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
  __device__ static void store4(__nv_bfloat16* p, const float (&f)[4]) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack(f[0], f[1]),
                                              pack(f[2], f[3]));
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

// The backward, summed by destination. Each cell of the (S, H, W, C)
// gradient reads the list of terms it receives and sums them itself:
//   1. count: a thread a pixel of the M pairs' planes adds one to the count
//      of each valid corner's cell (32-bit integer atomics);
//   2. scan: the counts' exclusive prefix sum, each cell's first record;
//   3. place: each valid corner takes a slot in its cell's run (an integer
//      atomic counting its cell down) and writes a record there: the
//      pixel's flat index m * H * W + p and its weight;
//   4. sum: G = C / V threads a cell, V channels a thread, read the cell's
//      records twice: first the largest |w * g| of each channel (and
//      whether a term is NaN or infinite), which sets the channel's unit
//      2^lg = 2^(eG - 62 + ceil(log2 n)) for the cell's n terms, |t| <
//      2^eG; then each term w * g (rounded to float32 as the plain version
//      rounds the product) as an integer number of units into a 64-bit
//      register, whose sum cannot overflow. Integer addition is
//      associative, so the records' order, which the place pass's atomics
//      leave to chance, does not matter. The sum is rounded once to float32
//      (and that to bfloat16) and written: every element of grad, no
//      zeroing and no cast pass.
// A term keeps its bits down to 2^(c - 61) of its cell's largest term (c =
// ceil(log2 n); 2^-59 for the 3-to-12 terms of the DIS-MF cells), far below
// a float32 ulp of the sum.
//
// Why by destination: at C = 32 the records are shared by the channels, so
// the passes that move them (count, place) do one atomic a corner, not C;
// a fixed-point scatter (as K3 bwd, csrc/warp2d.cu) would add two
// 64-bit atomics a corner and channel, and sm_90 has vector atomics for
// floats only: at the DIS-MF shapes it took 3.73 ms in bfloat16 against the
// float-atomic scatter's 0.54 ms on an H100 (chip_smoke.py phase 3), the L2
// atomic units bounding it. What bounds this design on the H100: the sum pass's reads
// of g, one row of C channels a record (64 bytes in bfloat16), gathered
// by the records and read twice, mostly from L2 since a cell's records are
// its neighbours' records' neighbours.

// One pixel of the M pairs' planes: its corners' cells and weights.
struct Corners {
  long long cell[4];
  float w[4];
  bool valid[4];
};

__device__ __forceinline__ Corners corners(const float* __restrict__ flow,
                                           const int* __restrict__ src,
                                           long long i, int H, int W) {
  const long long HW = (long long)H * W;
  const long long m = i / HW;
  const int p = (int)(i - m * HW);
  const int v = p / W;
  const int u = p - v * W;
  const Taps t = taps_at(__ldg(flow + 2 * i), __ldg(flow + 2 * i + 1), u, v,
                         H, W);
  const long long plane = (long long)__ldg(src + m) * HW;
  Corners k;
  k.valid[0] = t.vy0 && t.vx0;
  k.valid[1] = t.vy0 && t.vx1;
  k.valid[2] = t.vy1 && t.vx0;
  k.valid[3] = t.vy1 && t.vx1;
  k.cell[0] = plane + (long long)t.y0 * W + t.x0;
  k.cell[1] = plane + (long long)t.y0 * W + t.x1;
  k.cell[2] = plane + (long long)t.y1 * W + t.x0;
  k.cell[3] = plane + (long long)t.y1 * W + t.x1;
  k.w[0] = t.w00;
  k.w[1] = t.w01;
  k.w[2] = t.w10;
  k.w[3] = t.w11;
  return k;
}

// Passes 1 (PLACE false: count) and 3 (PLACE true: place), a thread a pixel
// of the n = M * H * W pixels.
template <bool PLACE>
__global__ void __launch_bounds__(256)
    pairs_bwd_index_kernel(const float* __restrict__ flow,
                           const int* __restrict__ src, int* count,
                           const int* __restrict__ start,
                           int2* __restrict__ recs, long long n, int H,
                           int W) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const Corners k = corners(flow, src, i, H, W);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (!k.valid[q]) continue;
    if constexpr (PLACE) {
      const int slot = atomicSub(count + k.cell[q], 1) - 1;
      recs[start[k.cell[q]] + slot] = make_int2((int)i, __float_as_int(k.w[q]));
    } else {
      atomicAdd(count + k.cell[q], 1);
    }
  }
}

constexpr int kScanItems = 4;                  // a thread's items
constexpr int kScanBlock = 256 * kScanItems;   // a block's items

// The exclusive prefix sum of v over the block's 256 threads, and the
// block's total.
__device__ __forceinline__ int block_exclusive_scan(int v, int& total) {
  __shared__ int warp_sum[8];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const int s = warp_sum[w];
    if (w < warp) before += s;
    total += s;
  }
  __syncthreads();
  return before + x - v;
}

// A block's items: kScanItems consecutive counts a thread.
__device__ __forceinline__ int thread_items(const int* __restrict__ count,
                                            long long n, long long first,
                                            int (&c)[kScanItems]) {
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    c[j] = first + j < n ? count[first + j] : 0;
    sum += c[j];
  }
  return sum;
}

// Pass 2a: each block's total.
__global__ void __launch_bounds__(256)
    scan_totals_kernel(const int* __restrict__ count, long long n,
                       int* __restrict__ totals) {
  int c[kScanItems];
  const long long first =
      (long long)blockIdx.x * kScanBlock + threadIdx.x * kScanItems;
  int total;
  block_exclusive_scan(thread_items(count, n, first, c), total);
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

// Pass 2b: the blocks' totals scanned in place by one block, their sum
// after them (totals[nb]).
__global__ void __launch_bounds__(256) scan_blocks_kernel(int* totals,
                                                          int nb) {
  int carry = 0;
  for (int base = 0; base < nb; base += 256) {
    const int i = base + threadIdx.x;
    const int v = i < nb ? totals[i] : 0;
    int total;
    const int before = block_exclusive_scan(v, total);
    if (i < nb) totals[i] = carry + before;
    carry += total;
  }
  if (threadIdx.x == 0) totals[nb] = carry;
}

// Pass 2c: start[i] for every cell, and start[n], the records in all.
__global__ void __launch_bounds__(256)
    scan_starts_kernel(const int* __restrict__ count, long long n,
                       const int* __restrict__ totals, int nb,
                       int* __restrict__ start) {
  int c[kScanItems];
  const long long first =
      (long long)blockIdx.x * kScanBlock + threadIdx.x * kScanItems;
  int total;
  int run = totals[blockIdx.x] +
            block_exclusive_scan(thread_items(count, n, first, c), total);
#pragma unroll
  for (int j = 0; j < kScanItems; ++j)
    if (first + j < n) {
      start[first + j] = run;
      run += c[j];
    }
  if (blockIdx.x == 0 && threadIdx.x == 0) start[n] = totals[nb];
}

// V channels of g at p, widened to float32: a 16-byte load (V = 4 float32),
// an 8-byte one (V = 4 bfloat16) or a scalar.
template <int V>
__device__ __forceinline__ void load_channels(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  } else {
    v[0] = __ldg(p);
  }
}
template <int V>
__device__ __forceinline__ void load_channels(const __nv_bfloat16* p,
                                              float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(r.x << 16);
    v[1] = __uint_as_float(r.x & 0xffff0000u);
    v[2] = __uint_as_float(r.y << 16);
    v[3] = __uint_as_float(r.y & 0xffff0000u);
  } else {
    v[0] = load_f32(p);
  }
}

// The integer number of units 2^lg nearest the finite float t (half up).
__device__ __forceinline__ long long to_units(float t, int lg) {
  const unsigned b = __float_as_uint(t);
  const unsigned ex = (b >> 23) & 0xffu;
  long long m = ex ? (long long)((b & 0x7fffffu) | 0x800000u)
                   : (long long)(b & 0x7fffffu);
  if (b >> 31) m = -m;
  const int d = (ex ? (int)ex - 150 : -149) - lg;  // t = m * 2^d units
  if (d >= 0) return (long long)((unsigned long long)m << d);
  const int sh = -d;
  return sh > 62 ? 0 : (m + (1ll << (sh - 1))) >> sh;
}

// Pass 4: thread i of cells * G sums channels [l * V, l * V + V) of cell
// i / G (l = i % G) over the cell's records.
template <typename T, int V>
__global__ void __launch_bounds__(256)
    pairs_bwd_sum_kernel(const int* __restrict__ start,
                         const int2* __restrict__ recs,
                         const T* __restrict__ g, T* __restrict__ grad,
                         long long cells, int G, int C) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= cells * G) return;
  const long long cell = i / G;
  const int c0 = (int)(i - cell * G) * V;
  const int b = start[cell];
  const int e = start[cell + 1];
  unsigned top[V];        // the largest finite |term|'s bits
  unsigned flags[V];      // 1 NaN, 2 +inf, 4 -inf
#pragma unroll
  for (int j = 0; j < V; ++j) top[j] = flags[j] = 0u;
  for (int r = b; r < e; ++r) {
    const int2 rec = __ldg(recs + r);
    float gv[V];
    load_channels<V>(g + (long long)rec.x * C + c0, gv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const unsigned t =
          __float_as_uint(__fmul_rn(gv[j], __int_as_float(rec.y)));
      const unsigned a = t & 0x7fffffffu;
      if (a < 0x7f800000u)
        top[j] = max(top[j], a);
      else
        flags[j] |= a > 0x7f800000u ? 1u : (t >> 31) ? 4u : 2u;
    }
  }
  const int n = e - b;
  const int c = n > 1 ? 32 - __clz(n - 1) : 0;   // 2^c >= n
  int lg[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ex = (int)(top[j] >> 23);
    lg[j] = (ex == 0 ? -126 : ex - 126) - 62 + c;  // |term| < 2^(lg + 62 - c)
  }
  long long acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0;
  for (int r = b; r < e; ++r) {
    const int2 rec = __ldg(recs + r);
    float gv[V];
    load_channels<V>(g + (long long)rec.x * C + c0, gv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float t = __fmul_rn(gv[j], __int_as_float(rec.y));
      if ((__float_as_uint(t) & 0x7fffffffu) < 0x7f800000u)
        acc[j] += to_units(t, lg[j]);
    }
  }
  float out[V];
#pragma unroll
  for (int j = 0; j < V; ++j)
    out[j] = flags[j] ? (flags[j] & 1u || flags[j] == 6u
                             ? __int_as_float(0x7fc00000)
                             : flags[j] == 2u ? __int_as_float(0x7f800000)
                                              : __int_as_float(0xff800000))
                      : round_fixed(acc[j], lg[j]);
  T* o = grad + cell * C + c0;
  if constexpr (V == 4) {
    Vec<T>::store4(o, out);
  } else {
    store_f32(o, out[0]);
  }
}

// The workspace of a call, in 4-byte words: the counts, the starts, the
// scan's block totals, then the records (8 bytes each, one a valid
// corner, at most 4 a pixel), each part on a 16-byte boundary.
struct Work {
  long long cells, nb, count, start, totals, recs, words;
};

inline long long round4(long long x) { return (x + 3) / 4 * 4; }

inline Work work_of(int S, int M, int H, int W) {
  Work w;
  w.cells = (long long)S * H * W;
  w.nb = (w.cells + kScanBlock - 1) / kScanBlock;
  w.count = 0;
  w.start = round4(w.cells);
  w.totals = w.start + round4(w.cells + 1);
  w.recs = w.totals + round4(w.nb + 1);
  w.words = w.recs + 8LL * M * H * W;
  return w;
}

// The passes of one call into grad: parts & 1 zeroes the counts, & 2
// counts, & 4 scans, & 8 places the records, & 16 sums.
template <typename T>
int bwd(const float* flow, const int* src, const T* g, int* work, T* grad,
        int S, int M, int H, int W, int C, int vector, int parts,
        cudaStream_t s) {
  const Work w = work_of(S, M, H, W);
  const long long pixels = (long long)M * H * W;
  if (w.cells == 0) return 0;
  if (4 * pixels >= (1LL << 31) || (vector && C % 4))
    return (int)cudaErrorInvalidValue;
  int* count = work + w.count;
  int* start = work + w.start;
  int* totals = work + w.totals;
  int2* recs = reinterpret_cast<int2*>(work + w.recs);
  const unsigned pix_blocks = (unsigned)((pixels + 255) / 256);
  int err = 0;
  if (parts & 1)
    err = (int)cudaMemsetAsync(count, 0, sizeof(int) * w.cells, s);
  if (!err && (parts & 2) && pixels) {
    pairs_bwd_index_kernel<false><<<pix_blocks, 256, 0, s>>>(
        flow, src, count, start, recs, pixels, H, W);
    err = (int)cudaGetLastError();
  }
  if (!err && (parts & 4)) {
    scan_totals_kernel<<<(unsigned)w.nb, 256, 0, s>>>(count, w.cells,
                                                      totals);
    scan_blocks_kernel<<<1, 256, 0, s>>>(totals, (int)w.nb);
    scan_starts_kernel<<<(unsigned)w.nb, 256, 0, s>>>(count, w.cells, totals,
                                                      (int)w.nb, start);
    err = (int)cudaGetLastError();
  }
  if (!err && (parts & 8) && pixels) {
    pairs_bwd_index_kernel<true><<<pix_blocks, 256, 0, s>>>(
        flow, src, count, start, recs, pixels, H, W);
    err = (int)cudaGetLastError();
  }
  if (!err && (parts & 16)) {
    const int V = vector ? 4 : 1;
    const int G = C / V;
    const unsigned blocks = (unsigned)((w.cells * G + 255) / 256);
    if (vector)
      pairs_bwd_sum_kernel<T, 4><<<blocks, 256, 0, s>>>(start, recs, g, grad,
                                                         w.cells, G, C);
    else
      pairs_bwd_sum_kernel<T, 1><<<blocks, 256, 0, s>>>(start, recs, g, grad,
                                                         w.cells, G, C);
    err = (int)cudaGetLastError();
  }
  return err;
}

int bwd_any(const float* flow, const int* src, const void* g, void* work,
            void* grad, int S, int M, int H, int W, int C, int bf16,
            int vector, int parts, cudaStream_t s) {
  return bf16 ? bwd<__nv_bfloat16>(flow, src, (const __nv_bfloat16*)g,
                                   (int*)work, (__nv_bfloat16*)grad, S, M, H,
                                   W, C, vector, parts, s)
              : bwd<float>(flow, src, (const float*)g, (int*)work,
                           (float*)grad, S, M, H, W, C, vector, parts, s);
}

#ifdef DIS_AB_VARIANTS
// The float-atomic backward this design replaced, for the before-and-after
// timing only: a vector scatter of 4-channel float4 atomics (RED.ADD.F32x4)
// into a float32 scratch zeroed first, then for bfloat16 a cast; its sums'
// order, and so their last bits, vary from run to run.
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
int atomic_bwd(const float* flow, const int* src, const int* order,
               const void* g, float* scratch, void* grad_bf16, int S, int M,
               int H, int W, int C, int bf16, cudaStream_t s) {
  const long long n = (long long)S * H * W * C;
  const int G = C / 4;
  if (C % 4 || G > kThreads) return (int)cudaErrorInvalidValue;
  int err = (int)cudaMemsetAsync(scratch, 0, sizeof(float) * (size_t)n, s);
  if (err) return err;
  const dim3 block(G, kThreads / G);
  const dim3 grid(((H * W + 7) / 8 + block.y - 1) / block.y, M);
  if (bf16)
    warp2d_pairs_bwd_vec_kernel<__nv_bfloat16, 1, 8><<<grid, block, 0, s>>>(
        flow, src, order, (const __nv_bfloat16*)g, scratch, H, W, C);
  else
    warp2d_pairs_bwd_vec_kernel<float, 1, 8><<<grid, block, 0, s>>>(
        flow, src, order, (const float*)g, scratch, H, W, C);
  err = (int)cudaGetLastError();
  if (err || !bf16 || n == 0) return err;
  const long long want = n / 4 / 256 + 1;
  f32_to_bf16_kernel<<<(int)(want < 132 * 32 ? want : 132 * 32), 256, 0, s>>>(
      scratch, (__nv_bfloat16*)grad_bf16, n);
  return (int)cudaGetLastError();
}
#endif

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
// The workspace dis_warp2d_pairs_bwd needs, in bytes (16-byte aligned).
extern "C" long long dis_warp2d_pairs_bwd_work(int S, int M, int H, int W) {
  return 4 * work_of(S, M, H, W).words;
}

// flow: contiguous (M, H, W, 2) float32 in pixels, (u, v); src: (M,) int32
// on the device, 0 <= src[m] < S; g: contiguous (M, H, W, C) float32 or
// bfloat16; work: dis_warp2d_pairs_bwd_work(S, M, H, W) bytes, 16-byte
// aligned; grad: contiguous (S, H, W, C) in g's type, written whole.
// vector = 1 sums 4 channels a thread, which needs C a multiple of 4, g
// aligned to 4 channels (16 bytes in float32, 8 in bfloat16) and grad as
// well; vector = 0 one channel a thread. Needs 4 * M * H * W < 2^31.
// Returns the first CUDA error of its launches, or cudaErrorInvalidValue for
// a shape it does not take.
extern "C" int dis_warp2d_pairs_bwd(const float* flow, const int* src,
                                    const void* g, void* work, void* grad,
                                    int S, int M, int H, int W, int C,
                                    int bf16, int vector, void* stream) {
  return bwd_any(flow, src, g, work, grad, S, M, H, W, C, bf16, vector, 31,
                 (cudaStream_t)stream);
}

#ifdef DIS_AB_VARIANTS
// For the before-and-after timing (chip_smoke.py phase 3,
// scripts/ab_torch_kernels.py), built with -DDIS_AB_VARIANTS only:
// dis_warp2d_pairs_bwd with one part of the call alone (parts, as bwd
// takes them: 1 zeroing, 2 count, 4 scan, 8 place, 16 sum) or, with
// atomic = 1, that float-atomic vector scatter: work taken as a float32
// (S, H, W, C) scratch (it must hold 4 * S*H*W*C bytes), zeroed and
// scattered into with float4 atomics in the source-major order (an int32
// permutation of the M pairs), then for bfloat16 cast into grad (for
// float32 the result is the scratch; grad unused).
extern "C" int dis_ab_warp2d_pairs_bwd(const float* flow, const int* src,
                                       const int* order, const void* g,
                                       void* work, void* grad, int S, int M,
                                       int H, int W, int C, int bf16,
                                       int vector, int atomic, int parts,
                                       void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (atomic)
    return atomic_bwd(flow, src, order, g, (float*)work, grad, S, M, H, W, C,
                      bf16, s);
  return bwd_any(flow, src, g, work, grad, S, M, H, W, C, bf16, vector, parts,
                 s);
}
#endif
