"""Fused Pallas-Triton matcher == XLA matcher (interpret mode on CPU)."""

import numpy as np
import jax.numpy as jnp
import pytest

from cusift_tpu.config import MatchConfig
from cusift_tpu.ops.match import match, resolve_backend, xla_top2
from cusift_tpu.ops.pallas.matcher import BM, BN, top2

TRITON = MatchConfig(backend="triton")


def _unit(rng, *shape):
    x = rng.normal(size=shape + (128,)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _match_triton(a, va, b, vb, cfg=TRITON):
    return match(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b),
                 jnp.asarray(vb), cfg, interpret=True)


@pytest.mark.parametrize("n,m", [(256, 256), (300, 512), (512, 300)])
def test_matches_xla_path(rng, n, m):
    a, b = _unit(rng, n), _unit(rng, m)
    va = np.ones(n, bool)
    vb = np.ones(m, bool)
    vb[m // 3] = False
    cfg = MatchConfig(ratio_thresh=0.95, backend="xla")
    ref = match(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b), jnp.asarray(vb), cfg)
    got = _match_triton(a, va, b, vb,
                        MatchConfig(ratio_thresh=0.95, backend="triton"))
    np.testing.assert_array_equal(np.asarray(got.idx), np.asarray(ref.idx))
    np.testing.assert_allclose(np.asarray(got.dist), np.asarray(ref.dist),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.ratio), np.asarray(ref.ratio),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got.ok), np.asarray(ref.ok))


def test_all_invalid_b(rng):
    a, b = _unit(rng, 256), _unit(rng, 256)
    got = _match_triton(a, np.ones(256, bool), b, np.zeros(256, bool))
    assert not np.asarray(got.ok).any()


def test_single_valid_candidate_not_vacuous(rng):
    """With one valid B row the second-best is -inf and the ratio is 0;
    the isfinite(s2) guard must reject instead of passing every query."""
    a, b = _unit(rng, 64), _unit(rng, 64)
    vb = np.zeros(64, bool)
    vb[5] = True
    got = _match_triton(a, np.ones(64, bool), b, vb)
    assert not np.asarray(got.ok).any()
    ref = match(jnp.asarray(a), jnp.ones(64, bool), jnp.asarray(b),
                jnp.asarray(vb), MatchConfig(backend="xla"))
    np.testing.assert_array_equal(np.asarray(got.ok), np.asarray(ref.ok))


def test_cross_check_branch_interpret(rng):
    """The triton branch with cross_check (the swapped second kernel
    call) == the XLA cross-check result."""
    a, b = _unit(rng, 256), _unit(rng, 300)
    va = np.ones(256, bool)
    va[7] = False
    vb = np.ones(300, bool)
    vb[100] = False
    cfg_x = MatchConfig(ratio_thresh=0.95, cross_check=True, backend="xla")
    cfg_t = MatchConfig(ratio_thresh=0.95, cross_check=True, backend="triton")
    ref = match(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b),
                jnp.asarray(vb), cfg_x)
    got = _match_triton(a, va, b, vb, cfg_t)
    assert np.asarray(ref.ok).any()
    np.testing.assert_array_equal(np.asarray(got.idx), np.asarray(ref.idx))
    np.testing.assert_array_equal(np.asarray(got.ok), np.asarray(ref.ok))


def test_checkify_matcher_idx_bounds(rng):
    """The kernel's best index always names a real B row: B is padded to
    a multiple of the column tile (72 -> 128 here) and the padded columns
    must never win."""
    from jax.experimental import checkify

    a, b = _unit(rng, 64), _unit(rng, 72)

    def checked_match(*x):
        m = match(*x, MatchConfig(cross_check=True, backend="triton"),
                  interpret=True)
        checkify.check(jnp.all((m.idx >= 0) & (m.idx < 72)),
                       "matcher: best-match index out of range")
        return m

    err, m = checkify.checkify(checked_match)(
        jnp.asarray(a), jnp.ones(64, bool), jnp.asarray(b),
        jnp.ones(72, bool))
    err.throw()
    assert np.asarray(m.idx).max() < 72


@pytest.mark.parametrize("n,m", [(BN - 3, BM + 5), (2 * BN + 1, 3)])
def test_top2_padding_matches_reference(rng, n, m):
    """Row and column padding to the tile sizes changes nothing: padded
    query rows are sliced off, padded columns are masked like invalid
    ones (even when B has fewer rows than one column tile)."""
    a, b = _unit(rng, 2, n), _unit(rng, 2, m)
    vb = np.ones((2, m), bool)
    vb[1, 0] = False
    got = top2(jnp.asarray(a), jnp.asarray(b), jnp.asarray(vb),
               interpret=True)
    ref = xla_top2(jnp.asarray(a), jnp.asarray(b), jnp.asarray(vb))
    assert all(g.shape == (2, n) for g in got)
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(ref[2]))
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(ref[1]),
                               atol=1e-6)


@pytest.mark.parametrize("backend", ["xla", "triton"])
def test_pair_batch_matches_single_pairs(rng, backend):
    """A leading pair axis matches every pair in one call (one kernel grid
    over (pair, row block)) with the per-pair results."""
    d = _unit(rng, 4, 96)
    v = np.ones((4, 96), bool)
    v[2, 10:20] = False
    cfg = MatchConfig(backend=backend)
    batch = match(jnp.asarray(d[:-1]), jnp.asarray(v[:-1]),
                  jnp.asarray(d[1:]), jnp.asarray(v[1:]), cfg,
                  interpret=True)
    for p in range(3):
        one = match(jnp.asarray(d[p]), jnp.asarray(v[p]),
                    jnp.asarray(d[p + 1]), jnp.asarray(v[p + 1]), cfg,
                    interpret=True)
        for got, ref in zip(batch, one):
            np.testing.assert_array_equal(np.asarray(got[p]),
                                          np.asarray(ref))


def test_backend_choice(monkeypatch):
    """"auto" takes the kernel only on the GPU and only for pair batches
    of at least KERNEL_MIN_ROWS query rows; explicit values stand."""
    import jax
    from cusift_tpu.ops.match import KERNEL_MIN_ROWS

    big, small = 7 * 6144, 1024
    assert big >= KERNEL_MIN_ROWS > small
    assert resolve_backend(MatchConfig(), big) == "xla"     # CPU suite
    assert resolve_backend(MatchConfig(backend="triton"), small) == "triton"
    assert resolve_backend(MatchConfig(backend="xla"), big) == "xla"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert resolve_backend(MatchConfig(), big) == "triton"
    assert resolve_backend(MatchConfig(), KERNEL_MIN_ROWS) == "triton"
    assert resolve_backend(MatchConfig(), KERNEL_MIN_ROWS - 1) == "xla"
    assert resolve_backend(MatchConfig(), small) == "xla"
