// A fixed-point sum rounded once to float32, shared by the deterministic
// backwards of K3/K5 (warp2d.cu) and K4 (warp2d_pairs.cu).
//
// Both add their terms as integers in units of 2^lg and convert each cell's
// exact sum at the end. A cast through double would round twice (to 53 bits,
// then to 24) and could land one float ulp off in a tie; this rounds the
// integer itself to 24 significant bits, to nearest even, keeping no bit
// below 2^-149 (float32's subnormals), so the result is the exact sum
// rounded once. An exact result above float32's range becomes +-inf, as a
// float sum's overflow does.

#pragma once

// (neg ? -mag : mag) * 2^lg rounded to float32; a zero sum gives +0.
__device__ __forceinline__ float round_fixed(unsigned __int128 mag, bool neg,
                                             int lg) {
  if (mag == 0) return 0.0f;
  const unsigned long long h = (unsigned long long)(mag >> 64);
  const int top = h ? 127 - __clzll((long long)h)
                    : 63 - __clzll((long long)(unsigned long long)mag);
  float f;
  if (top + lg >= -126) {
    // a normal result (or +-inf): the top 64 bits, with a sticky bit for
    // any set below them, rounded once by the conversion, then scaled
    // exactly (the sticky bit lies far below the 24 kept)
    const int drop = top > 63 ? top - 63 : 0;
    unsigned long long m = (unsigned long long)(mag >> drop);
    if (drop && (mag & (((unsigned __int128)1 << drop) - 1))) m |= 1;
    f = ldexpf(__ull2float_rn(m), lg + drop);
  } else if (lg >= -149) {
    // a subnormal result with no bit below 2^-149 (mag < 2^23): exact
    f = ldexpf((float)(unsigned long long)mag, lg);
  } else {
    // a subnormal result: round at 2^-149, sh bits dropped
    const int sh = -149 - lg;
    unsigned long long r = 0;
    unsigned __int128 rem = mag;
    if (sh < 128) {
      r = (unsigned long long)(mag >> sh);
      rem = mag - ((unsigned __int128)r << sh);
    }
    const unsigned __int128 half = sh <= 128
                                       ? (unsigned __int128)1 << (sh - 1)
                                       : ~(unsigned __int128)0;
    if (rem > half || (rem == half && (r & 1))) ++r;
    // r <= 2^23: exact
    f = ldexpf((float)r, -149);
  }
  return neg ? -f : f;
}

// The signed 64-bit integer n times 2^lg, rounded once to float32.
__device__ __forceinline__ float round_fixed(long long n, int lg) {
  const bool neg = n < 0;
  const unsigned long long m =
      neg ? 0ull - (unsigned long long)n : (unsigned long long)n;
  return round_fixed((unsigned __int128)m, neg, lg);
}
