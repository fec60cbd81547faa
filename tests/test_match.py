"""P4 exit tests (SURVEY.md §7): matcher vs brute-force oracle."""

import numpy as np
import jax.numpy as jnp

from cusift_tpu.config import MatchConfig
from cusift_tpu.ops.match import match


def _unit(rng, n, d=128):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_self_match_identity(rng):
    a = _unit(rng, 64)
    m = match(jnp.asarray(a), jnp.ones(64, bool), jnp.asarray(a), jnp.ones(64, bool),
              MatchConfig(ratio_thresh=2.0))
    np.testing.assert_array_equal(np.asarray(m.idx), np.arange(64))
    np.testing.assert_allclose(np.asarray(m.dist), 0.0, atol=1e-3)


def test_matches_numpy_oracle(rng):
    a, b = _unit(rng, 100), _unit(rng, 120)
    m = match(jnp.asarray(a), jnp.ones(100, bool), jnp.asarray(b), jnp.ones(120, bool),
              MatchConfig(ratio_thresh=0.95))
    d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)  # [100, 120]
    order = np.argsort(d, axis=1)
    best, second = order[:, 0], order[:, 1]
    np.testing.assert_array_equal(np.asarray(m.idx), best)
    np.testing.assert_allclose(np.asarray(m.dist), d[np.arange(100), best],
                               rtol=1e-4, atol=1e-4)
    ratio = d[np.arange(100), best] / d[np.arange(100), second]
    np.testing.assert_array_equal(np.asarray(m.ok), ratio < 0.95)


def test_invalid_masked(rng):
    a, b = _unit(rng, 32), _unit(rng, 32)
    valid_b = np.ones(32, bool)
    valid_b[5] = False
    # make b[5] the perfect match of a[0]; it must be ignored
    b[5] = a[0]
    m = match(jnp.asarray(a), jnp.ones(32, bool), jnp.asarray(b),
              jnp.asarray(valid_b), MatchConfig(ratio_thresh=2.0))
    assert int(m.idx[0]) != 5
    valid_a = np.ones(32, bool)
    valid_a[3] = False
    m2 = match(jnp.asarray(a), jnp.asarray(valid_a), jnp.asarray(b),
               jnp.asarray(valid_b), MatchConfig(ratio_thresh=2.0))
    assert not bool(m2.ok[3])


def test_cross_check(rng):
    a, b = _unit(rng, 40), _unit(rng, 40)
    m = match(jnp.asarray(a), jnp.ones(40, bool), jnp.asarray(b), jnp.ones(40, bool),
              MatchConfig(ratio_thresh=2.0, cross_check=True))
    idx = np.asarray(m.idx)
    d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
    back = np.argmin(d, axis=0)
    ok = np.asarray(m.ok)
    np.testing.assert_array_equal(ok, back[idx] == np.arange(40))
