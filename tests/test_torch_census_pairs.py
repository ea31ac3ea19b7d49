"""The pair decomposition of K1 and K1 bwd (csrc/census_sad.cu) on the CPU.

Two plain-torch mirrors of the kernels' algebra, each visiting every
unordered pixel pair {x, p = x + o}, o in the half window O+ (40 offsets),
once, with the backward's two signs taken as the kernels take them and its
one exchanged value v:
- "counts": over the image, the two terms weighted by the border counts
  n(x, p) and n(p, x) of replicate padding;
- "padding": the kernels' form, over the edge-padded plane (4 pixels each
  side) with no counts, g zero at padding positions, the output read off
  the image and the gradient of the padding folded onto the border.
Both are held against the port's plain versions and the JAX package's
census_sad and its VJP at 1e-5, on seeded inputs and on inputs with exact
ties (values on a 1/4 grid, a flat region, es == ta on a patch)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from depthinspace_tpu.ops.census import census_sad as jax_census_sad
from depthinspace_tpu_torch.ops.census import (_unpad_edge_adjoint,
                                               census_sad_bwd_plain,
                                               census_sad_plain)
from depthinspace_tpu_torch.ops.sampling import pad_edge

RADIUS = 4
EPS = 0.5
HALF_WINDOW = [(dy, dx) for dy in range(RADIUS + 1)
               for dx in range(-RADIUS, RADIUS + 1) if dy > 0 or dx > 0]


def _counts(n: int) -> torch.Tensor:
    """(n, n): [c, t] = #{d in [-4, 4] : clamp(c + d, 0, n - 1) == t}."""
    c = torch.zeros(n, n)
    for i in range(n):
        for d in range(-RADIUS, RADIUS + 1):
            c[i, min(max(i + d, 0), n - 1)] += 1
    return c


def _pair_mirror(es, ta, g=None, eps=EPS):
    """The counts form over the image: census_sad(es, ta) without g, else
    the gradient of <g, census_sad(es, ta)> with respect to es."""
    N, H, W = es.shape
    rows, cols = _counts(H), _counts(W)
    acc = torch.zeros_like(es)
    for dy, dx in HALF_WINDOW:
        if dy >= H or abs(dx) >= W:
            continue
        # x over the pixels whose partner p = x + o lies in the image
        xr, pr = slice(0, H - dy), slice(dy, H)
        xc = slice(max(0, -dx), W - max(0, dx))
        pc = slice(max(0, dx), W + min(0, dx))
        ry, cx = torch.arange(H - dy), torch.arange(xc.start, xc.stop)
        n_xp = rows[ry, ry + dy][:, None] * cols[cx, cx + dx][None]
        n_px = rows[ry + dy, ry][:, None] * cols[cx + dx, cx][None]
        a = es[:, pr, pc] - es[:, xr, xc]
        b = ta[:, pr, pc] - ta[:, xr, xc]
        ra = torch.rsqrt(a * a + eps)
        rb = torch.rsqrt(b * b + eps)
        ua, ub = a * ra, b * rb
        if g is None:
            # |h(a) - h(b)| = |h(-a) - h(-b)| = |a ra - b rb| / 2
            t = (ua - ub).abs()
            assert bool((t >= 0).all())
            acc[:, xr, xc] += n_xp * t
            acc[:, pr, pc] += n_px * t
        else:
            x_c, y_c = 1.0 + ua, 1.0 + ub
            x_n, y_n = 1.0 - ua, 1.0 - ub
            s_c = (x_c > y_c).float() - (x_c < y_c).float()
            s_n = (x_n > y_n).float() - (x_n < y_n).float()
            v = 0.5 * eps * ra ** 3 / 81 * (n_xp * s_c * g[:, xr, xc]
                                             - n_px * s_n * g[:, pr, pc])
            acc[:, pr, pc] += v
            acc[:, xr, xc] -= v
    return acc * (0.5 / 81) if g is None else acc


def _padded_mirror(es, ta, g=None, eps=EPS):
    """The kernels' form: the pairs of the edge-padded plane, no counts."""
    P = RADIUS
    es_p, ta_p = pad_edge(es, P), pad_edge(ta, P)
    g_p = None if g is None else torch.nn.functional.pad(g, (P, P, P, P))
    Hp, Wp = es_p.shape[1:]
    acc = torch.zeros_like(es_p)
    for dy, dx in HALF_WINDOW:
        xr, pr = slice(0, Hp - dy), slice(dy, Hp)
        xc = slice(max(0, -dx), Wp - max(0, dx))
        pc = slice(max(0, dx), Wp + min(0, dx))
        a = es_p[:, pr, pc] - es_p[:, xr, xc]
        b = ta_p[:, pr, pc] - ta_p[:, xr, xc]
        ra = torch.rsqrt(a * a + eps)
        rb = torch.rsqrt(b * b + eps)
        ua, ub = a * ra, b * rb
        if g is None:
            t = (ua - ub).abs()
            acc[:, xr, xc] += t
            acc[:, pr, pc] += t
        else:
            x_c, y_c = 1.0 + ua, 1.0 + ub
            x_n, y_n = 1.0 - ua, 1.0 - ub
            s_c = (x_c > y_c).float() - (x_c < y_c).float()
            s_n = (x_n > y_n).float() - (x_n < y_n).float()
            v = 0.5 * eps * ra ** 3 / 81 * (s_c * g_p[:, xr, xc]
                                             - s_n * g_p[:, pr, pc])
            acc[:, pr, pc] += v
            acc[:, xr, xc] -= v
    if g is None:
        return acc[:, P:-P, P:-P] * (0.5 / 81)
    return _unpad_edge_adjoint(acc, P)


MIRRORS = {"counts": _pair_mirror, "padding": _padded_mirror}


def _inputs(shape, kind, seed=0):
    rng = np.random.RandomState(seed)
    es, ta, g = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    N, H, W = shape
    if kind == "quarter grid":
        es, ta = np.round(es * 4) / 4, np.round(ta * 4) / 4
    elif kind == "flat region":
        es[:, :max(H // 2, 1), :max(W // 2, 1)] = 0.25
        ta[:, :max(H // 2, 1), :max(W // 2, 1)] = -0.5
    elif kind == "es == ta patch":
        es[:, H // 3:, W // 3:] = ta[:, H // 3:, W // 3:]
    return es.astype(np.float32), ta.astype(np.float32), g


SHAPES = [(1, 1, 7), (1, 5, 3), (2, 9, 7), (3, 37, 50)]
KINDS = ["randn", "quarter grid", "flat region", "es == ta patch"]


def test_half_window_covers_the_window_once():
    """O+, its negation and the centre are the 81 offsets, each once."""
    assert len(HALF_WINDOW) == 40
    full = set(HALF_WINDOW) | {(-dy, -dx) for dy, dx in HALF_WINDOW}
    assert len(full) == 80 and (0, 0) not in full
    assert full | {(0, 0)} == {(dy, dx) for dy in range(-4, 5)
                               for dx in range(-4, 5)}


@pytest.mark.parametrize("mirror", list(MIRRORS))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_pair_forward_matches_plain_and_jax(shape, kind, mirror):
    es, ta, _ = _inputs(shape, kind)
    out = MIRRORS[mirror](torch.from_numpy(es), torch.from_numpy(ta))
    plain = census_sad_plain(torch.from_numpy(es), torch.from_numpy(ta))
    ref = np.asarray(jax_census_sad(jnp.asarray(es), jnp.asarray(ta), 9,
                                    EPS))
    torch.testing.assert_close(out, plain, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mirror", list(MIRRORS))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_pair_backward_matches_plain_and_jax(shape, kind, mirror):
    """The signs of both roles agree with the plain version's: a flipped
    sign costs up to 2 * 0.71 * |g| / 81 ~ 1e-2 at a pixel, far above the
    1e-5 of summing in another order."""
    es, ta, g = _inputs(shape, kind)
    t_es, t_ta, t_g = map(torch.from_numpy, (es, ta, g))
    grad = MIRRORS[mirror](t_es, t_ta, t_g)
    plain = census_sad_bwd_plain(t_es, t_ta, t_g)
    _, vjp = jax.vjp(lambda e: jax_census_sad(e, jnp.asarray(ta), 9, EPS),
                     jnp.asarray(es))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    torch.testing.assert_close(grad, plain, rtol=0, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), ref, rtol=0, atol=1e-5)
