// Census-SAD photometric dissimilarity, forward (kernel K1).
//
// Replaces: depthinspace_tpu/ops/pallas/census_kernel.py::_forward (the
// Pallas body _fwd_kernel), reached through census_sad_auto.
//
//   out(p) = sum_{o in 9x9} |h(es(p+o) - es(p)) - h(ta(p+o) - ta(p))| / 81
//   h(d)   = 0.5 * (1 + d * rsqrt(d^2 + eps))
//
// with replicate (edge) padding at the image border.
//
// What bounds it on the H100: arithmetic. Each output pixel runs 81 taps of
// two rsqrt (special-function unit) and about ten FMA-pipe operations, and
// reads two f32 inputs and writes one f32: ~0.2 kFLOP per 12 bytes, far
// above the card's ~20 FLOP/byte balance point for f32.
//
// Design: one block computes a 32x32 output tile. It first copies the
// tile's 40x40 halo window of es and ta into shared memory (12.8 KB) with
// CLAMPED indices, which is the replicate padding, so the stencil loop reads
// only shared memory and never tests a border. Neighbouring threads read
// neighbouring words (no bank conflicts). The TPU kernel's row bands and
// lane rolls existed for Mosaic's layout rules and are not reproduced.
// rsqrtf is the hardware approximation (<= 2 ulp): the result differs from
// the plain PyTorch version by a few 1e-7, and chip_smoke.py holds it to
// 1e-5.

#include <cuda_runtime.h>

namespace {

constexpr int kRadius = 4;                   // 9x9 window
constexpr int kTile = 32;                    // output tile is kTile x kTile
constexpr int kRowsPerPass = 8;              // blockDim = (kTile, kRowsPerPass)
constexpr int kSmem = kTile + 2 * kRadius;   // 40

__device__ __forceinline__ float soft_heaviside(float d, float eps) {
  return 0.5f * (1.0f + d * rsqrtf(d * d + eps));
}

__global__ void __launch_bounds__(kTile * kRowsPerPass)
census_sad_fwd_kernel(const float* __restrict__ es,
                      const float* __restrict__ ta, float* __restrict__ out,
                      int H, int W, float eps) {
  __shared__ float s_es[kSmem][kSmem];
  __shared__ float s_ta[kSmem][kSmem];

  const long long plane = (long long)H * W;
  const long long base = (long long)blockIdx.z * plane;
  const int x_tile = blockIdx.x * kTile;
  const int y_tile = blockIdx.y * kTile;

  const int tid = threadIdx.y * kTile + threadIdx.x;
  for (int i = tid; i < kSmem * kSmem; i += kTile * kRowsPerPass) {
    const int sy = i / kSmem;
    const int sx = i - sy * kSmem;
    const int gy = min(max(y_tile + sy - kRadius, 0), H - 1);
    const int gx = min(max(x_tile + sx - kRadius, 0), W - 1);
    const long long g = base + (long long)gy * W + gx;
    s_es[sy][sx] = es[g];
    s_ta[sy][sx] = ta[g];
  }
  __syncthreads();

  const int tx = threadIdx.x;
  const int gx = x_tile + tx;
  for (int ty = threadIdx.y; ty < kTile; ty += kRowsPerPass) {
    const int gy = y_tile + ty;
    if (gx >= W || gy >= H) continue;
    const float ce = s_es[ty + kRadius][tx + kRadius];
    const float ct = s_ta[ty + kRadius][tx + kRadius];
    float acc = 0.0f;
#pragma unroll
    for (int dy = 0; dy <= 2 * kRadius; ++dy) {
#pragma unroll
      for (int dx = 0; dx <= 2 * kRadius; ++dx) {
        const float h_es = soft_heaviside(s_es[ty + dy][tx + dx] - ce, eps);
        const float h_ta = soft_heaviside(s_ta[ty + dy][tx + dx] - ct, eps);
        acc += fabsf(h_es - h_ta);
      }
    }
    out[base + (long long)gy * W + gx] =
        acc / (float)((2 * kRadius + 1) * (2 * kRadius + 1));
  }
}

// Census-SAD backward (kernel K1 bwd), the adjoint to es only.
//
// Replaces: depthinspace_tpu/ops/pallas/census_kernel.py::_backward (the
// Pallas body _bwd_kernel plus the XLA band sum and _unpad_edge_adjoint),
// reached through _vjp_bwd. CPU truth: ops/census.py::_census_bwd.
//
// The scatter form of the adjoint, for a pixel p and an offset o with
// neighbour q = clamp(p + o) (replicate padding):
//   delta(p, o) = sign(h(es(q) - es(p)) - h(ta(q) - ta(p)))
//                 * 0.5 * eps * (d^2 + eps)^(-3/2) * g(p) / 81
//   grad(q) += delta(p, o);   grad(p) -= delta(p, o)
//
// Design: the gather form, one thread per output pixel x, deterministic and
// free of atomics. Every term that reaches x pairs x with a pixel p of its
// 9x9 window (clamp(p + o) = x only if |p - x| <= 4), so x visits each p of
// the window once and evaluates the pair's difference a = es(p) - es(x),
// b = ta(p) - ta(x) and their two rsqrt once, then adds both roles of the
// pair:
//   x as the neighbour of p: m(p, x) * delta with d = -a and g(p),
//   x as the centre of p:    -n(x, p) * delta with d = a and g(x),
// where m(p, x) = #{o : clamp(p + o) = x} and n(x, p) = #{o : clamp(x + o)
// = p} fold the replicate-padding margins back onto the border (1 inside
// the image, up to 5 per axis on an edge). Both counts factor into a row
// count times a column count. Each unordered pair is evaluated at both of
// its pixels, so the kernel does 162 rsqrt per pixel, the same number as
// the scatter form. es, ta and g are read from a shared-memory tile with a
// 4-pixel halo, loaded with clamped indices like the forward; pairs whose p
// lies outside the image get zero counts.
//
// What bounds it on the H100: the special-function units, 2 rsqrt per pair.
// The sign is computed with round-to-nearest intrinsics in the plain
// version's order of operations, so it agrees with the plain version wherever
// rsqrtf and torch.rsqrt agree; the sums are taken in another order.

__device__ __forceinline__ int clamp_count(int c, int t, int n) {
  // #{d in [-kRadius, kRadius] : clamp(c + d, 0, n - 1) == t}
  const int lo = (t == 0) ? -(1 << 20) : t;
  const int hi = (t == n - 1) ? (1 << 20) : t;
  return max(0, min(kRadius, hi - c) - max(-kRadius, lo - c) + 1);
}

__device__ __forceinline__ float sign_of(float v) {
  return (float)(v > 0.0f) - (float)(v < 0.0f);
}

// h(d) = 0.5 * (1 + d * r) with r = rsqrt(d^2 + eps), in the plain order.
__device__ __forceinline__ float soft_heaviside_rn(float d, float r) {
  return __fmul_rn(0.5f, __fadd_rn(1.0f, __fmul_rn(d, r)));
}

__global__ void __launch_bounds__(kTile * kRowsPerPass)
census_sad_bwd_kernel(const float* __restrict__ es,
                      const float* __restrict__ ta,
                      const float* __restrict__ g, float* __restrict__ grad,
                      int H, int W, float eps, float half_eps, float inv_b2) {
  __shared__ float s_es[kSmem][kSmem];
  __shared__ float s_ta[kSmem][kSmem];
  __shared__ float s_g[kSmem][kSmem];

  const long long plane = (long long)H * W;
  const long long base = (long long)blockIdx.z * plane;
  const int x_tile = blockIdx.x * kTile;
  const int y_tile = blockIdx.y * kTile;

  const int tid = threadIdx.y * kTile + threadIdx.x;
  for (int i = tid; i < kSmem * kSmem; i += kTile * kRowsPerPass) {
    const int sy = i / kSmem;
    const int sx = i - sy * kSmem;
    const int gy = min(max(y_tile + sy - kRadius, 0), H - 1);
    const int gx = min(max(x_tile + sx - kRadius, 0), W - 1);
    const long long idx = base + (long long)gy * W + gx;
    s_es[sy][sx] = es[idx];
    s_ta[sy][sx] = ta[idx];
    s_g[sy][sx] = g[idx];
  }
  __syncthreads();

  const int tx = threadIdx.x;
  const int gx = x_tile + tx;
  // column counts of this thread's pixel, shared by all its rows
  float m_col[2 * kRadius + 1], n_col[2 * kRadius + 1];
#pragma unroll
  for (int dx = 0; dx <= 2 * kRadius; ++dx) {
    const int pc = gx + dx - kRadius;
    const bool in = pc >= 0 && pc < W;
    m_col[dx] = in ? (float)clamp_count(pc, gx, W) : 0.0f;
    n_col[dx] = in ? (float)clamp_count(gx, pc, W) : 0.0f;
  }

  for (int ty = threadIdx.y; ty < kTile; ty += kRowsPerPass) {
    const int gy = y_tile + ty;
    if (gx >= W || gy >= H) continue;
    const float ce = s_es[ty + kRadius][tx + kRadius];
    const float ct = s_ta[ty + kRadius][tx + kRadius];
    const float cg = s_g[ty + kRadius][tx + kRadius];
    float acc = 0.0f;
#pragma unroll
    for (int dy = 0; dy <= 2 * kRadius; ++dy) {
      const int pr = gy + dy - kRadius;
      const bool in = pr >= 0 && pr < H;
      const float m_row = in ? (float)clamp_count(pr, gy, H) : 0.0f;
      const float n_row = in ? (float)clamp_count(gy, pr, H) : 0.0f;
#pragma unroll
      for (int dx = 0; dx <= 2 * kRadius; ++dx) {
        const float pe = s_es[ty + dy][tx + dx];
        const float pt = s_ta[ty + dy][tx + dx];
        // centre x, neighbour p: d = a; centre p, neighbour x: d = -a
        const float a = __fsub_rn(pe, ce);
        const float b = __fsub_rn(pt, ct);
        const float na = __fsub_rn(ce, pe);
        const float nb = __fsub_rn(ct, pt);
        const float ra = rsqrtf(__fadd_rn(__fmul_rn(a, a), eps));
        const float rb = rsqrtf(__fadd_rn(__fmul_rn(b, b), eps));
        const float s_centre = sign_of(__fsub_rn(soft_heaviside_rn(a, ra),
                                                 soft_heaviside_rn(b, rb)));
        const float s_neigh = sign_of(__fsub_rn(soft_heaviside_rn(na, ra),
                                                soft_heaviside_rn(nb, rb)));
        const float dh = half_eps * ra * ra * ra;
        const float d_neigh = __fmul_rn(__fmul_rn(__fmul_rn(s_neigh, dh),
                                                  s_g[ty + dy][tx + dx]),
                                        inv_b2);
        const float d_centre = __fmul_rn(__fmul_rn(__fmul_rn(s_centre, dh),
                                                   cg), inv_b2);
        acc += m_row * m_col[dx] * d_neigh - n_row * n_col[dx] * d_centre;
      }
    }
    grad[base + (long long)gy * W + gx] = acc;
  }
}

}  // namespace

// es, ta, out: contiguous (N, H, W) float32 on the current device.
// Returns cudaGetLastError() after the launch.
extern "C" int dis_census_sad_fwd(const float* es, const float* ta,
                                  float* out, int N, int H, int W, float eps,
                                  void* stream) {
  const dim3 block(kTile, kRowsPerPass);
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, N);
  census_sad_fwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      es, ta, out, H, W, eps);
  return (int)cudaGetLastError();
}

// es, ta, g, grad: contiguous (N, H, W) float32; grad = d<g, out>/d es.
// half_eps = 0.5 * eps, inv_b2 = 1 / 81. Returns cudaGetLastError().
extern "C" int dis_census_sad_bwd(const float* es, const float* ta,
                                  const float* g, float* grad, int N, int H,
                                  int W, float eps, float half_eps,
                                  float inv_b2, void* stream) {
  const dim3 block(kTile, kRowsPerPass);
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, N);
  census_sad_bwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      es, ta, g, grad, H, W, eps, half_eps, inv_b2);
  return (int)cudaGetLastError();
}

extern "C" const char* dis_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
