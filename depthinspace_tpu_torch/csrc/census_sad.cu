// Census-SAD photometric dissimilarity (kernel K1) and its adjoint to es
// (K1 bwd).
//
// Replaces: depthinspace_tpu/ops/pallas/census_kernel.py::_forward (the
// Pallas body _fwd_kernel, reached through census_sad_auto) and ::_backward
// (_bwd_kernel plus the XLA band sum and _unpad_edge_adjoint, reached
// through _vjp_bwd). CPU truth: ops/census.py::census_sad_plain and
// census_sad_bwd_plain.
//
//   out(c) = sum_{o in 9x9} |h(es(c + o) - es(c)) - h(ta(c + o) - ta(c))| / 81
//   h(d)   = 0.5 (1 + d rsqrt(d^2 + eps)),  es(v) = es(clamp(v)) outside
//
// Each unordered pixel pair once. Take the half window O+ = {dy > 0, or
// dy = 0 and dx > 0} (40 offsets; the centre adds 0). Every term of the sum,
// centre c and offset o, is a term of exactly one pair {x, p = x + o'},
// o' in O+: the term of x as the centre (o = o', c = x) or of p as the
// centre (o = -o', c = p). Over the edge-padded plane, where x or p may be
// a padding position v with the value at clamp(v), this holds with no
// border counts: a pair is evaluated wherever one of its pixels is a real
// centre. With a = es(p) - es(x), b = ta(p) - ta(x), ra = rsqrt(a^2 + eps),
// rb = rsqrt(b^2 + eps):
//   the term of x:  |h(a) - h(b)|   = |a ra - b rb| / 2,
//   the term of p:  |h(-a) - h(-b)| = the same,
// so 2 rsqrt per pair, not 4. The forward adds |a ra - b rb| to both pixels
// (scaled by 0.5 / 81 at the end) and writes only real pixels. The
// backward, with s_c = sign(h(a) - h(b)), s_n = sign(h(-a) - h(-b)),
// h'(a) = 0.5 eps ra^3 and g prescaled by 0.5 eps / 81 and 0 at padding
// positions (they are no centres):
//   v = ra^3 (s_c g(x) - s_n g(p)),   grad(p) += v,  grad(x) -= v,
// and the gradient a padding position collects is folded onto the border
// pixel it copies (rows above and below in the row accumulators, columns
// left and right by a warp sum), as the adjoint of edge padding does.
// The signs are taken exactly as the plain version rounds them:
// s_c = (X > Y) - (X < Y) with X = fl(1 + fl(a ra)), Y = fl(1 + fl(b rb))
// (the factor 0.5 is exact, and the sign of fl(X - Y) is that of X - Y),
// and s_n compares fl(1 - fl(a ra)) with fl(1 - fl(b rb)), because
// fl((-a) ra) = -fl(a ra). The products and sums feeding them use
// round-to-nearest intrinsics, so none is contracted into an FMA.
//
// Design. One warp walks down a band of 64 columns, two adjacent columns a
// lane, and writes the middle 56 (a 4-column halo each side) for `rows`
// rows; it starts 4 rows above them. At each row r the lane evaluates the
// pairs (x, x + o), o in O+, of its two pixels x, and adds each pair's two
// contributions to register accumulators of the 5 rows r..r+4: partners in
// the lane's own columns directly, partners in the 8 columns of the lanes
// 1 and 2 to either side in 8 per-column accumulators. When row r is
// complete, those 8 go to their lanes by warp shuffles (8 a row), are added
// in a fixed order, and the row is written: no atomics, no shared-memory
// exchange, and the same bits on every run. The band's rows pass through a
// ring of 8 staged rows in shared memory (es and ta with clamped indices,
// the edge padding; g zero outside the image), each lane loading the next
// row into registers one row ahead.
//
// Pairs evaluated: each pair once, plus the halo. A band of R rows walks
// R + 4 rows, its first 4 only for the pairs that reach its first row (9,
// 18, 27, 36 of a pixel's 40: 2.25 rows' worth), and its lanes hold 64
// columns for 56, so at 512 x 432 (8 bands, 448 columns) a pixel takes
// (R + 2.25) / R x 64 / 56 x 448 / 432 of its 40 pairs: R = 16, the
// forward at N = 8: 1.352, 54.1 pairs and 108 rsqrt a pixel; R = 32, the
// forward at N = 32 and the backward at N = 8: 1.268, 50.7 and 101; R = 64,
// the backward at N = 32: 1.227, 49.1 and 98. It was 81 pairs and 162
// rsqrt; the floor is 39.6 pairs and 79.2 rsqrt.
//
// What bounds them on the H100. Forward: the special-function units, 2
// rsqrt a pair at 16 a clock an SM, against 8 FP32-pipe instructions a
// pair at 128 a clock. Backward: FP32-pipe issue, ~28 instructions a pair
// (the exact-order differences and signs, ra^3, the signed products and the
// two accumulations) against the 16 clocks of its 2 rsqrt. rsqrt is
// rsqrt.approx.ftz.f32 (<= 2 ulp): its input a^2 + eps is normal for eps >=
// FLT_MIN, so flushing denormals changes nothing, and it is the value
// torch.rsqrt gives on the card.

#include <cuda_runtime.h>

namespace {

constexpr int kRadius = 4;                     // 9x9 window
constexpr int kWarp = 32;
constexpr int kSpan = 2 * kWarp;               // columns a warp evaluates
constexpr int kOwned = kSpan - 2 * kRadius;    // 56 columns it writes
constexpr int kStage = kSpan + 2 * kRadius;    // 72 staged columns
constexpr int kRing = 8;                       // staged rows (5 read, 1 next)
constexpr int kWarpsPerBlock = 4;
constexpr int kTaps = 2 * kRadius + 1;
constexpr int kNext = kRadius + 1;             // rows r..r+4 in flight

__device__ __forceinline__ float rsqrt_approx(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// whether a row step is one of the band's first kRadius (halo) rows
template <bool kHalo>
struct Halo {
  static constexpr bool value = kHalo;
};

// index of a partner column offset t = j + dx outside the lane's own two
// columns (t in -4..-1, 2..5) in the lane's per-column accumulators
__host__ __device__ constexpr int target(int t) {
  return t < 0 ? t + 4 : t + 2;
}

// A warp's band: image n, rows [r0, r1), columns [c0, c0 + kOwned); its
// lanes hold columns c0 - 4 .. c0 + 59, staged columns c0 - 8 .. c0 + 63.
struct Band {
  long long base;  // n * H * W
  int r0, r1, c0;
};

__device__ __forceinline__ bool warp_band(int N, int H, int W, int rows,
                                          int col_bands, int row_bands,
                                          Band* band) {
  const int item = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int cb = item % col_bands;
  const int rest = item / col_bands;
  const int rb = rest % row_bands;
  const int n = rest / row_bands;
  if (n >= N) return false;
  band->base = (long long)n * H * W;
  band->r0 = rb * rows;
  band->r1 = min(band->r0 + rows, H);
  band->c0 = cb * kOwned;
  return true;
}

// Loads row gr of the band's staged columns of src into 3 registers a
// lane (staged column lane + 32 k): the clamped pixel (edge padding), or 0
// outside the image when zero_outside.
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         const Band& b, int gr, int H, int W,
                                         int lane, bool zero_outside,
                                         float v[3]) {
  const bool row_in = gr >= 0 && gr < H;
  const long long row = b.base + (long long)min(max(gr, 0), H - 1) * W;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int sc = lane + kWarp * k;
    const int c = b.c0 - 2 * kRadius + sc;
    const bool in = row_in && c >= 0 && c < W;
    v[k] = (sc >= kStage || (zero_outside && !in))
               ? 0.0f
               : src[row + min(max(c, 0), W - 1)];
  }
}

__device__ __forceinline__ void store_row(float* s_row, int lane,
                                          const float v[3], float scale) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int sc = lane + kWarp * k;
    if (sc < kStage) s_row[sc] = v[k] * scale;
  }
}

// The partner contributions the lanes' accumulators hold for one row,
// summed at their lanes in a fixed order: .x for the lane's column 0, .y
// for its column 1. Lanes past the warp's ends contribute 0.
__device__ __forceinline__ float2 exchange(const float (&snd)[8], int lane) {
  constexpr unsigned kAll = 0xffffffffu;
  const float d2e = __shfl_down_sync(kAll, snd[target(-4)], 2);
  const float d1e = __shfl_down_sync(kAll, snd[target(-2)], 1);
  const float u1e = __shfl_up_sync(kAll, snd[target(2)], 1);
  const float u2e = __shfl_up_sync(kAll, snd[target(4)], 2);
  const float d2o = __shfl_down_sync(kAll, snd[target(-3)], 2);
  const float d1o = __shfl_down_sync(kAll, snd[target(-1)], 1);
  const float u1o = __shfl_up_sync(kAll, snd[target(3)], 1);
  const float u2o = __shfl_up_sync(kAll, snd[target(5)], 2);
  const bool lo2 = lane < kWarp - 2, lo1 = lane < kWarp - 1;
  const bool hi1 = lane >= 1, hi2 = lane >= 2;
  float2 r;
  r.x = (lo2 ? d2e : 0.0f) + (lo1 ? d1e : 0.0f) + (hi1 ? u1e : 0.0f) +
        (hi2 ? u2e : 0.0f);
  r.y = (lo2 ? d2o : 0.0f) + (lo1 ? d1o : 0.0f) + (hi1 ? u1o : 0.0f) +
        (hi2 ? u2o : 0.0f);
  return r;
}

// Writes row r of the band's owned pixels: lanes 2..29, real columns.
__device__ __forceinline__ void write_row(float* __restrict__ dst,
                                          const Band& b, int r, int W,
                                          int lane, float v0, float v1) {
  if (r < b.r0 || r >= b.r1 || lane < 2 || lane >= kWarp - 2) return;
  const int gc = b.c0 - kRadius + 2 * lane;
  const long long row = b.base + (long long)r * W;
  if (gc < W) dst[row + gc] = v0;
  if (gc + 1 < W) dst[row + gc + 1] = v1;
}

// Moves the accumulators of rows r+1..r+4 down one row and clears row
// r+5's: own[i] and snd[i] belong to row r + i.
__device__ __forceinline__ void shift(float (&own)[kNext][2],
                                      float (&snd)[kNext][8]) {
#pragma unroll
  for (int i = 0; i + 1 < kNext; ++i) {
    own[i][0] = own[i + 1][0];
    own[i][1] = own[i + 1][1];
#pragma unroll
    for (int t = 0; t < 8; ++t) snd[i][t] = snd[i + 1][t];
  }
  own[kNext - 1][0] = own[kNext - 1][1] = 0.0f;
#pragma unroll
  for (int t = 0; t < 8; ++t) snd[kNext - 1][t] = 0.0f;
}

// Adds the accumulators of row i to row j (before the exchange).
__device__ __forceinline__ void fold_row(float (&own)[kNext][2],
                                         float (&snd)[kNext][8], int i,
                                         int j) {
  own[j][0] += own[i][0];
  own[j][1] += own[i][1];
#pragma unroll
  for (int t = 0; t < 8; ++t) snd[j][t] += snd[i][t];
}

// Stages the band's first kNext rows and loads the next into v.
__device__ __forceinline__ void stage_first(const float* __restrict__ src,
                                            float (*s)[kStage], const Band& b,
                                            int H, int W, int lane,
                                            bool zero_outside, float scale,
                                            float v[3]) {
  for (int i = 0; i < kNext; ++i) {
    load_row(src, b, b.r0 - kRadius + i, H, W, lane, zero_outside, v);
    store_row(s[i], lane, v, scale);
  }
  load_row(src, b, b.r0 - kRadius + kNext, H, W, lane, zero_outside, v);
}

// ---------------------------------------------------------------- forward

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
census_sad_fwd_kernel(const float* __restrict__ es,
                      const float* __restrict__ ta, float* __restrict__ out,
                      int N, int H, int W, int rows, int col_bands,
                      int row_bands, float eps) {
  __shared__ __align__(16) float s_es_all[kWarpsPerBlock][kRing][kStage];
  __shared__ __align__(16) float s_ta_all[kWarpsPerBlock][kRing][kStage];
  Band b;
  if (!warp_band(N, H, W, rows, col_bands, row_bands, &b)) return;
  float (*s_es)[kStage] = s_es_all[threadIdx.x >> 5];
  float (*s_ta)[kStage] = s_ta_all[threadIdx.x >> 5];
  const int lane = threadIdx.x & (kWarp - 1);
  const int xs = kRadius + 2 * lane;  // staged column of the lane's pixel 0

  float ve[3], vt[3];
  stage_first(es, s_es, b, H, W, lane, false, 1.0f, ve);
  stage_first(ta, s_ta, b, H, W, lane, false, 1.0f, vt);
  __syncwarp();

  float own[kNext][2], snd[kNext][8];
#pragma unroll
  for (int k = 0; k < kNext; ++k) {
    own[k][0] = own[k][1] = 0.0f;
#pragma unroll
    for (int t = 0; t < 8; ++t) snd[k][t] = 0.0f;
  }
  const float scale = 0.5f / (float)(kTaps * kTaps);
  const int first = b.r0 - kRadius;

  // one row step; Halo<true> for the band's first kRadius rows, which
  // evaluate only the pairs that reach row r0
  auto step = [&](const int s, auto halo) {
    const int r = first + s;
    const float2 ce = *reinterpret_cast<const float2*>(&s_es[s & 7][xs]);
    const float2 ct = *reinterpret_cast<const float2*>(&s_ta[s & 7][xs]);
#pragma unroll
    for (int dy = 0; dy <= kRadius; ++dy) {
      // a halo row's pairs count only where they reach row r0
      if (decltype(halo)::value && dy < kRadius - s) continue;
      const int slot = (s + dy) & 7;
      // partner values at staged columns xs - 4 .. xs + 5
      float pe[10], pt[10];
#pragma unroll
      for (int u = 0; u < 10; u += 2) {
        const float2 e2 =
            *reinterpret_cast<const float2*>(&s_es[slot][xs - kRadius + u]);
        const float2 t2 =
            *reinterpret_cast<const float2*>(&s_ta[slot][xs - kRadius + u]);
        pe[u] = e2.x; pe[u + 1] = e2.y;
        pt[u] = t2.x; pt[u + 1] = t2.y;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float cej = j ? ce.y : ce.x;
        const float ctj = j ? ct.y : ct.x;
#pragma unroll
        for (int dx = (dy == 0 ? 1 : -kRadius); dx <= kRadius; ++dx) {
          const int t = j + dx;
          const float a = pe[t + kRadius] - cej;
          const float bb = pt[t + kRadius] - ctj;
          const float ra = rsqrt_approx(fmaf(a, a, eps));
          const float rb = rsqrt_approx(fmaf(bb, bb, eps));
          const float d = fabsf(fmaf(a, ra, -(bb * rb)));
          own[0][j] += d;
          if (t == 0 || t == 1) {
            own[dy][t] += d;
          } else {
            snd[dy][target(t)] += d;
          }
        }
      }
    }
    // row r is complete: gather the partners' terms and write
    const float2 in = exchange(snd[0], lane);
    write_row(out, b, r, W, lane, (own[0][0] + in.x) * scale,
              (own[0][1] + in.y) * scale);
    shift(own, snd);
    // the row kNext ahead into the freed slot, and the next one loaded
    store_row(s_es[(s + kNext) & 7], lane, ve, 1.0f);
    store_row(s_ta[(s + kNext) & 7], lane, vt, 1.0f);
    load_row(es, b, r + kNext + 1, H, W, lane, false, ve);
    load_row(ta, b, r + kNext + 1, H, W, lane, false, vt);
    __syncwarp();
  };
  const int steps = b.r1 - first;
  int s = 0;
#pragma unroll 1
  for (; s < min(kRadius, steps); ++s) step(s, Halo<true>());
#pragma unroll 1
  for (; s < steps; ++s) step(s, Halo<false>());
}

// --------------------------------------------------------------- backward

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
census_sad_bwd_kernel(const float* __restrict__ es,
                      const float* __restrict__ ta,
                      const float* __restrict__ g, float* __restrict__ grad,
                      int N, int H, int W, int rows, int col_bands,
                      int row_bands, float eps, float g_scale) {
  __shared__ __align__(16) float s_es_all[kWarpsPerBlock][kRing][kStage];
  __shared__ __align__(16) float s_ta_all[kWarpsPerBlock][kRing][kStage];
  __shared__ __align__(16) float s_g_all[kWarpsPerBlock][kRing][kStage];
  Band b;
  if (!warp_band(N, H, W, rows, col_bands, row_bands, &b)) return;
  float (*s_es)[kStage] = s_es_all[threadIdx.x >> 5];
  float (*s_ta)[kStage] = s_ta_all[threadIdx.x >> 5];
  float (*s_g)[kStage] = s_g_all[threadIdx.x >> 5];
  const int lane = threadIdx.x & (kWarp - 1);
  const int xs = kRadius + 2 * lane;
  // the lane's columns, and whether the band holds padding columns
  const int gc = b.c0 - kRadius + 2 * lane;
  const bool edge_cols = b.c0 - kRadius < 0 || b.c0 + kSpan - kRadius > W;

  float ve[3], vt[3], vg[3];
  stage_first(es, s_es, b, H, W, lane, false, 1.0f, ve);
  stage_first(ta, s_ta, b, H, W, lane, false, 1.0f, vt);
  stage_first(g, s_g, b, H, W, lane, true, g_scale, vg);
  __syncwarp();

  float own[kNext][2], snd[kNext][8];
#pragma unroll
  for (int k = 0; k < kNext; ++k) {
    own[k][0] = own[k][1] = 0.0f;
#pragma unroll
    for (int t = 0; t < 8; ++t) snd[k][t] = 0.0f;
  }
  const int first = b.r0 - kRadius;

  // one row step; Halo<true> for the band's first kRadius rows, which
  // evaluate only the pairs that reach row r0
  auto step = [&](const int s, auto halo) {
    const int r = first + s;
    const float2 ce = *reinterpret_cast<const float2*>(&s_es[s & 7][xs]);
    const float2 ct = *reinterpret_cast<const float2*>(&s_ta[s & 7][xs]);
    const float2 cg = *reinterpret_cast<const float2*>(&s_g[s & 7][xs]);
#pragma unroll
    for (int dy = 0; dy <= kRadius; ++dy) {
      // a halo row's pairs count only where they reach row r0 (above the
      // image both pixels are padding with g = 0, and v = 0)
      if (decltype(halo)::value && dy < kRadius - s) continue;
      const int slot = (s + dy) & 7;
      float pe[10], pt[10], pg[10];
#pragma unroll
      for (int u = 0; u < 10; u += 2) {
        const int c = xs - kRadius + u;
        const float2 e2 = *reinterpret_cast<const float2*>(&s_es[slot][c]);
        const float2 t2 = *reinterpret_cast<const float2*>(&s_ta[slot][c]);
        const float2 g2 = *reinterpret_cast<const float2*>(&s_g[slot][c]);
        pe[u] = e2.x; pe[u + 1] = e2.y;
        pt[u] = t2.x; pt[u + 1] = t2.y;
        pg[u] = g2.x; pg[u + 1] = g2.y;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float cej = j ? ce.y : ce.x;
        const float ctj = j ? ct.y : ct.x;
        const float gx = j ? cg.y : cg.x;
#pragma unroll
        for (int dx = (dy == 0 ? 1 : -kRadius); dx <= kRadius; ++dx) {
          const int t = j + dx;
          // the plain version's roundings up to the signs
          const float a = __fsub_rn(pe[t + kRadius], cej);
          const float bb = __fsub_rn(pt[t + kRadius], ctj);
          const float ra = rsqrt_approx(__fadd_rn(__fmul_rn(a, a), eps));
          const float rb = rsqrt_approx(__fadd_rn(__fmul_rn(bb, bb), eps));
          const float ua = __fmul_rn(a, ra);
          const float ub = __fmul_rn(bb, rb);
          const float xc = __fadd_rn(1.0f, ua), yc = __fadd_rn(1.0f, ub);
          const float xn = __fsub_rn(1.0f, ua), yn = __fsub_rn(1.0f, ub);
          const float sc = (float)(xc > yc) - (float)(xc < yc);
          const float sn = (float)(xn > yn) - (float)(xn < yn);
          const float v = ra * ra * ra * (sc * gx - sn * pg[t + kRadius]);
          own[0][j] -= v;
          if (t == 0 || t == 1) {
            own[dy][t] += v;
          } else {
            snd[dy][target(t)] += v;
          }
        }
      }
    }
    // padding rows fold onto the border row: rows above the image are
    // carried into the next row, rows below it into row H - 1
    if (r < 0) fold_row(own, snd, 0, 1);
    if (r == H - 1) {
#pragma unroll
      for (int i = 1; i < kNext; ++i) fold_row(own, snd, i, 0);
    }
    float2 tot = exchange(snd[0], lane);
    tot.x += own[0][0];
    tot.y += own[0][1];
    if (edge_cols) {
      // padding columns fold onto columns 0 and W - 1 (a warp sum whose
      // bits every lane shares: each step adds the same two values)
      float left = (gc < 0 ? tot.x : 0.0f) + (gc + 1 < 0 ? tot.y : 0.0f);
      float right = (gc >= W ? tot.x : 0.0f) + (gc + 1 >= W ? tot.y : 0.0f);
#pragma unroll
      for (int m = 1; m < kWarp; m *= 2) {
        left += __shfl_xor_sync(0xffffffffu, left, m);
        right += __shfl_xor_sync(0xffffffffu, right, m);
      }
      if (gc == 0) tot.x += left;
      if (gc == W - 1) tot.x += right;
      if (gc + 1 == W - 1) tot.y += right;
    }
    write_row(grad, b, r, W, lane, tot.x, tot.y);
    shift(own, snd);
    store_row(s_es[(s + kNext) & 7], lane, ve, 1.0f);
    store_row(s_ta[(s + kNext) & 7], lane, vt, 1.0f);
    store_row(s_g[(s + kNext) & 7], lane, vg, g_scale);
    load_row(es, b, r + kNext + 1, H, W, lane, false, ve);
    load_row(ta, b, r + kNext + 1, H, W, lane, false, vt);
    load_row(g, b, r + kNext + 1, H, W, lane, true, vg);
    __syncwarp();
  };
  const int steps = b.r1 - first;
  int s = 0;
#pragma unroll 1
  for (; s < min(kRadius, steps); ++s) step(s, Halo<true>());
#pragma unroll 1
  for (; s < steps; ++s) step(s, Halo<false>());
}

// Rows a warp writes: the most of 64, 32, 16 that still gives the card's
// 132 SMs more than min_warps warps in all. A band of `rows` rows walks
// rows + 4 rows, the first 4 only for the pairs that reach its first row
// (2.1 rows' worth of pairs).
int band_rows(int N, int H, int col_bands, int min_warps) {
  int rows = 64;
  while (rows > 16 &&
         (long long)N * ((H + rows - 1) / rows) * col_bands <= min_warps) {
    rows /= 2;
  }
  return rows;
}

// The forward (96 registers, bound by the special-function units) wants
// more warps in flight than the backward (128 registers, FP32 issue):
// rows = 16 at N = 8 and 32 at N = 32 for the forward, 32 and 64 for the
// backward, the fastest of 16, 32 and 64 in scripts/ab_torch_kernels.py.
constexpr int kFwdMinWarps = 132 * 16;
constexpr int kBwdMinWarps = 132 * 4;

struct Grid {
  int rows, col_bands, row_bands;
  unsigned blocks;
};

Grid band_grid(int N, int H, int W, int rows, int min_warps) {
  Grid g;
  g.col_bands = (W + kOwned - 1) / kOwned;
  g.rows = rows > 0 ? rows : band_rows(N, H, g.col_bands, min_warps);
  g.row_bands = (H + g.rows - 1) / g.rows;
  const long long warps = (long long)N * g.row_bands * g.col_bands;
  g.blocks = (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  return g;
}

int fwd(const float* es, const float* ta, float* out, int N, int H, int W,
        float eps, int rows, void* stream) {
  const Grid g = band_grid(N, H, W, rows, kFwdMinWarps);
  census_sad_fwd_kernel<<<g.blocks, kWarpsPerBlock * kWarp, 0,
                          (cudaStream_t)stream>>>(
      es, ta, out, N, H, W, g.rows, g.col_bands, g.row_bands, eps);
  return (int)cudaGetLastError();
}

int bwd(const float* es, const float* ta, const float* g, float* grad, int N,
        int H, int W, float eps, float half_eps, float inv_b2, int rows,
        void* stream) {
  const Grid gr = band_grid(N, H, W, rows, kBwdMinWarps);
  census_sad_bwd_kernel<<<gr.blocks, kWarpsPerBlock * kWarp, 0,
                          (cudaStream_t)stream>>>(
      es, ta, g, grad, N, H, W, gr.rows, gr.col_bands, gr.row_bands, eps,
      half_eps * inv_b2);
  return (int)cudaGetLastError();
}

}  // namespace

// es, ta, out: contiguous (N, H, W) float32 on the current device; eps >=
// FLT_MIN. Returns cudaGetLastError() after the launch.
extern "C" int dis_census_sad_fwd(const float* es, const float* ta,
                                  float* out, int N, int H, int W, float eps,
                                  void* stream) {
  return fwd(es, ta, out, N, H, W, eps, 0, stream);
}

// es, ta, g, grad: contiguous (N, H, W) float32; grad = d<g, out>/d es.
// half_eps = 0.5 * eps, inv_b2 = 1 / 81. Returns cudaGetLastError().
extern "C" int dis_census_sad_bwd(const float* es, const float* ta,
                                  const float* g, float* grad, int N, int H,
                                  int W, float eps, float half_eps,
                                  float inv_b2, void* stream) {
  return bwd(es, ta, g, grad, N, H, W, eps, half_eps, inv_b2, 0, stream);
}

#ifdef DIS_AB_VARIANTS
// dis_census_sad_fwd / _bwd with the rows a warp writes given (16, 32 or
// 64; the entry points above choose by band_rows), for
// scripts/ab_torch_kernels.py.
extern "C" int dis_ab_census_sad_fwd(const float* es, const float* ta,
                                     float* out, int N, int H, int W,
                                     float eps, int rows, void* stream) {
  return fwd(es, ta, out, N, H, W, eps, rows, stream);
}

extern "C" int dis_ab_census_sad_bwd(const float* es, const float* ta,
                                     const float* g, float* grad, int N,
                                     int H, int W, float eps, float half_eps,
                                     float inv_b2, int rows, void* stream) {
  return bwd(es, ta, g, grad, N, H, W, eps, half_eps, inv_b2, rows, stream);
}
#endif

extern "C" const char* dis_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
