"""The XLA gradient sampler (ops/sampling.py) against a NumPy oracle.

The oracle spells out what the orientation and descriptor stages read:
central-difference gradients with zero border rows/columns, sampled
bilinearly at float coordinates clamped into the level, with an
in-bounds mask for samples that left it.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from cusift_tpu.ops.sampling import sample_grad_grid, sample_grad_pair


def _oracle(gauss, lvl, ys, xs):
    gauss = np.asarray(gauss, np.float64)
    _, h, w = gauss.shape
    gx = np.zeros_like(gauss)
    gy = np.zeros_like(gauss)
    gx[:, :, 1:-1] = 0.5 * (gauss[:, :, 2:] - gauss[:, :, :-2])
    gy[:, 1:-1, :] = 0.5 * (gauss[:, 2:, :] - gauss[:, :-2, :])
    ys, xs = np.asarray(ys, np.float64), np.asarray(xs, np.float64)
    inb = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    yc = np.clip(ys, 0.0, h - 1.000001)
    xc = np.clip(xs, 0.0, w - 1.000001)
    y0 = np.minimum(np.floor(yc).astype(int), h - 2)
    x0 = np.minimum(np.floor(xc).astype(int), w - 2)
    fy, fx = yc - y0, xc - x0
    lv = np.broadcast_to(np.asarray(lvl)[:, None], ys.shape)

    def lerp(g):
        top = g[lv, y0, x0] * (1 - fx) + g[lv, y0, x0 + 1] * fx
        bot = g[lv, y0 + 1, x0] * (1 - fx) + g[lv, y0 + 1, x0 + 1] * fx
        return top * (1 - fy) + bot * fy

    return lerp(gx), lerp(gy), inb


def _setup(rng, L=3, H=48, W=64, K=16, S=36, spread=8.0, margin=0.0):
    gauss = rng.normal(size=(L, H, W)).astype(np.float32)
    lvl = rng.integers(0, L, K).astype(np.int32)
    cy = rng.uniform(-margin, H - 1 + margin, K)
    cx = rng.uniform(-margin, W - 1 + margin, K)
    ys = (cy[:, None] + rng.uniform(-spread, spread, (K, S))).astype(np.float32)
    xs = (cx[:, None] + rng.uniform(-spread, spread, (K, S))).astype(np.float32)
    return gauss, lvl, ys, xs


def _check(gauss, lvl, ys, xs, atol=1e-5):
    dx, dy, inb = sample_grad_pair(jnp.asarray(gauss), jnp.asarray(lvl),
                                   jnp.asarray(ys), jnp.asarray(xs))
    rdx, rdy, rinb = _oracle(gauss, lvl, ys, xs)
    np.testing.assert_array_equal(np.asarray(inb), rinb)
    np.testing.assert_allclose(np.asarray(dx), rdx, atol=atol)
    np.testing.assert_allclose(np.asarray(dy), rdy, atol=atol)
    return np.asarray(dx), np.asarray(dy), np.asarray(inb)


def test_matches_numpy_oracle(rng):
    _check(*_setup(rng, margin=4.0))


def test_small_level(rng):
    """Levels smaller than one sample window: samples spill past every
    edge and are clamped, never read out of range."""
    _, _, inb = _check(*_setup(rng, L=2, H=6, W=9, K=8, S=25, spread=6.0))
    assert not inb.all()


def test_border_gradients_zero(rng):
    """Samples on the first/last row see zero dy; on the first/last
    column zero dx (up to the 1e-6 clamp that keeps the last row's
    bilinear neighbour in range)."""
    gauss = rng.normal(size=(1, 32, 40)).astype(np.float32)
    lvl, s = np.zeros(2, np.int32), 16
    line = np.tile(np.linspace(1.0, 30.0, s, dtype=np.float32), (2, 1))
    edge_y = np.stack([np.zeros(s), np.full(s, 31.0)]).astype(np.float32)
    edge_x = np.stack([np.zeros(s), np.full(s, 39.0)]).astype(np.float32)
    _, dy, inb = _check(gauss, lvl, edge_y, line)
    assert inb.all()
    np.testing.assert_allclose(dy, 0.0, atol=1e-5)
    dx, _, inb = _check(gauss, lvl, line, edge_x)
    assert inb.all()
    np.testing.assert_allclose(dx, 0.0, atol=1e-5)


@pytest.mark.parametrize("k", [1, 13, 21])
def test_slot_counts_not_multiple_of_8(rng, k):
    """Any slot count works, and padding extra slots changes nothing."""
    gauss, lvl, ys, xs = _setup(rng, K=k)
    dx, dy, _ = _check(gauss, lvl, ys, xs)
    pad = 8 - k % 8
    dx2, dy2, _ = sample_grad_pair(
        jnp.asarray(gauss), jnp.asarray(np.pad(lvl, (0, pad))),
        jnp.asarray(np.pad(ys, ((0, pad), (0, 0)))),
        jnp.asarray(np.pad(xs, ((0, pad), (0, 0)))))
    np.testing.assert_array_equal(np.asarray(dx2)[:k], dx)
    np.testing.assert_array_equal(np.asarray(dy2)[:k], dy)


def test_span_margin(rng):
    """Samples at the full descriptor span (4 cells x 3 sigma x the
    largest octave sigma x sqrt 2, ~38 px) around centres near the level
    edge stay exact: no wrapped or shifted reads at the window's ends."""
    gauss = rng.normal(size=(2, 128, 160)).astype(np.float32)
    n, s, span = 8, 64, 37.9
    cy = np.array([3.9, 124.1, 64.0, 0.5, 127.0, 20.0, 100.0, 64.2])
    cx = np.array([4.0, 155.9, 80.0, 159.0, 0.2, 140.0, 20.0, 80.1])
    t = np.linspace(-span / 2, span / 2, s)
    ys = (cy[:, None] + t[None, :]).astype(np.float32)
    xs = (cx[:, None] + t[::-1][None, :]).astype(np.float32)
    _check(gauss, np.arange(n, dtype=np.int32) % 2, ys, xs)


def test_grid_matches_expanded_pair(rng):
    """The axis-aligned grid form == the general form on its expansion."""
    gauss, lvl, _, _ = _setup(rng, K=5)
    gr, gc = 12, 12
    ys_rows = (rng.uniform(5, 40, (5, 1))
               + np.linspace(-6, 6, gr)[None]).astype(np.float32)
    xs_cols = (rng.uniform(5, 60, (5, 1))
               + np.linspace(-6, 6, gc)[None]).astype(np.float32)
    got = sample_grad_grid(jnp.asarray(gauss), jnp.asarray(lvl),
                           jnp.asarray(ys_rows), jnp.asarray(xs_cols))
    ys = np.broadcast_to(ys_rows[:, :, None], (5, gr, gc)).reshape(5, -1)
    xs = np.broadcast_to(xs_cols[:, None, :], (5, gr, gc)).reshape(5, -1)
    ref = _check(gauss, lvl, ys, xs)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), b)
