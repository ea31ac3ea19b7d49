"""csrc/round_fixed.cuh, the last step of K3/K5's and K4's deterministic
backwards: an exact integer sum times 2^lg rounded once to float32, to
nearest even. The header's device code is compiled for the host with g++
(its CUDA qualifiers and intrinsics defined as their host equivalents; an
x86-64 conversion of an integer to float rounds to nearest even, as
__ull2float_rn does) and held, bit for bit, to
an exact rational rounding in Python, on ties, subnormal results and
overflow included."""
import random
import shutil
import struct
import subprocess
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

HEADER = (Path(__file__).resolve().parents[1] / "depthinspace_tpu_torch"
          / "csrc" / "round_fixed.cuh")
HARNESS = r"""
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#define __device__
#define __forceinline__ inline
#define __clzll(x) __builtin_clzll((unsigned long long)(x))
#define __ull2float_rn(x) ((float)(unsigned long long)(x))
#include "round_fixed.cuh"
int main() {
  char kind[4];
  while (scanf("%3s", kind) == 1) {
    float f;
    if (kind[0] == 'u') {  // u hi64 lo64 neg lg: the 128-bit form
      unsigned long long h, l;
      int neg, lg;
      if (scanf("%llu %llu %d %d", &h, &l, &neg, &lg) != 4) return 1;
      f = round_fixed(((unsigned __int128)h << 64) | l, neg != 0, lg);
    } else {  // s n lg: the signed 64-bit form
      long long n;
      int lg;
      if (scanf("%lld %d", &n, &lg) != 2) return 1;
      f = round_fixed(n, lg);
    }
    uint32_t b;
    memcpy(&b, &f, 4);
    printf("%u\n", b);
  }
  return 0;
}
"""
F32_MAX = Fraction(float(np.finfo(np.float32).max))


def _bits(x) -> int:
    return struct.unpack("<I", struct.pack("<f", float(x)))[0]


def _rounded(mag: int, neg: bool, lg: int) -> int:
    """The bits of (neg ? -mag : mag) * 2^lg rounded to nearest even
    float32, found among the neighbours of a close float32 by their exact
    distances; +0 for 0, +-inf from half an ulp above the largest float."""
    if mag == 0:
        return 0
    x = mag * Fraction(2) ** lg
    if x >= F32_MAX + Fraction(2) ** 103:
        r = np.float32(np.inf)
    else:
        f0 = np.float32(min(float(x), float(F32_MAX)))
        cands = [f0, np.nextafter(f0, np.float32(0)),
                 np.nextafter(f0, np.float32(np.inf))]
        r = min((c for c in cands if np.isfinite(c)),
                key=lambda c: (abs(Fraction(float(c)) - x), _bits(c) & 1))
    return _bits(-r if neg else r)


def _magnitudes(kind: str, rng: random.Random, n: int):
    """(mag, neg, lg) triples of one kind."""
    out = []
    for _ in range(n):
        if kind == "ties":
            # 24 kept bits, then exactly half a unit, or just above it
            sh = rng.randint(1, 100)
            mag = (rng.getrandbits(24) | 1 << 23) << sh
            mag |= 1 << (sh - 1)
            if rng.random() < 0.5 and sh > 1:
                mag |= 1
            lg = rng.randint(-120, 0)
        elif kind == "subnormal":
            mag = rng.getrandbits(rng.randint(1, 60))
            lg = rng.randint(-200, -150)
        elif kind == "overflow":
            mag = rng.getrandbits(rng.randint(100, 127))
            lg = rng.randint(0, 40)
        else:
            mag = rng.getrandbits(rng.choice([5, 24, 25, 53, 54, 64, 90,
                                              123]))
            lg = rng.randint(-140, 20)
        out.append((mag, rng.random() < 0.5, lg))
    return out


@pytest.fixture(scope="module")
def round_fixed_host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the header for the host")
    d = tmp_path_factory.mktemp("round_fixed")
    (d / "harness.cpp").write_text(HARNESS)
    exe = d / "harness"
    subprocess.run([gxx, "-O2", "-std=c++17", "-I", str(HEADER.parent),
                    str(d / "harness.cpp"), "-o", str(exe)], check=True)

    def run(lines: list) -> list:
        res = subprocess.run([str(exe)], input="".join(lines),
                             capture_output=True, text=True, check=True)
        return [int(v) for v in res.stdout.split()]
    return run


@pytest.mark.parametrize("kind", ["wide", "ties", "subnormal", "overflow"])
def test_round_fixed_128_bit_rounds_once(round_fixed_host, kind):
    cases = _magnitudes(kind, random.Random(kind), 2000)
    got = round_fixed_host([f"u {m >> 64} {m & (2 ** 64 - 1)} {int(ng)} "
                            f"{lg}\n" for m, ng, lg in cases])
    want = [_rounded(m, ng, lg) for m, ng, lg in cases]
    bad = [(c, hex(g), hex(w)) for c, g, w in zip(cases, got, want)
           if g != w]
    assert not bad, f"{len(bad)} of {len(cases)} differ, e.g. {bad[:3]}"


def test_round_fixed_signed_64_bit_rounds_once(round_fixed_host):
    rng = random.Random(64)
    cases = [(rng.getrandbits(rng.choice([10, 24, 25, 53, 54, 62, 63]))
              * rng.choice([-1, 1]), rng.randint(-200, 60))
             for _ in range(2000)]
    # ties: 24 kept bits, then exactly half a unit
    for _ in range(1000):
        sh = rng.randint(1, 39)
        n = ((rng.getrandbits(24) | 1 << 23) << sh | 1 << (sh - 1))
        cases.append((n * rng.choice([-1, 1]), rng.randint(-180, 40)))
    cases += [(-(2 ** 63), 0), (2 ** 63 - 1, -10), (0, 5)]
    got = round_fixed_host([f"s {n} {lg}\n" for n, lg in cases])
    want = [_rounded(abs(n), n < 0, lg) for n, lg in cases]
    assert got == want
