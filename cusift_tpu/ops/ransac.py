"""Batched-hypothesis RANSAC: homography + 3D rigid transform.

Reference analog (SURVEY.md C13–C15): host RNG uploads random 4-subsets,
``ComputeHomographies`` runs thread-per-hypothesis 8x8 Gaussian elimination,
``TestHomographies`` counts inliers, host argmax picks the winner, then
``ImproveHomography`` does CPU IRLS; cuSIFT adds the 3-point Procrustes
RANSAC for RGB-D rigid alignment.  Design (SURVEY.md §2.2 row 4): a
static batch of hypotheses is one `vmap` over batched dense solves; inlier
scoring is a [HYP, N] broadcast; refinement is a jitted IRLS loop.  The
whole estimator is a single XLA program — no host in the loop.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from cusift_tpu.utils.precision import f32_matmuls

from ..config import RansacConfig
from .geometry import apply_homography, procrustes, solve_homography


class HomographyResult(NamedTuple):
    h: jnp.ndarray            # [3, 3]
    inliers: jnp.ndarray      # [N] bool
    num_inliers: jnp.ndarray  # int32
    ok: jnp.ndarray           # bool: enough matches / valid fit


class RigidResult(NamedTuple):
    r: jnp.ndarray            # [3, 3]
    t: jnp.ndarray            # [3]
    inliers: jnp.ndarray      # [N] bool
    num_inliers: jnp.ndarray  # int32
    ok: jnp.ndarray           # bool


def _sample_indices(key, n: int, valid: jnp.ndarray, nhyp: int, k: int):
    """[nhyp, k] indices drawn (approximately) from the valid set."""
    p = valid.astype(jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    return jax.random.choice(key, n, shape=(nhyp, k), replace=True, p=p)


def _onehot_weights(idx: jnp.ndarray, n: int) -> jnp.ndarray:
    """[k]-index set -> [n] weight vector selecting the minimal sample."""
    return jnp.zeros(n).at[idx].add(1.0)


@f32_matmuls
@partial(jax.jit, static_argnames=("cfg",))
def find_homography(pa: jnp.ndarray, pb: jnp.ndarray, valid: jnp.ndarray,
                    cfg: RansacConfig = RansacConfig(),
                    key: jax.Array | None = None) -> HomographyResult:
    """RANSAC homography pa -> pb over [N, 2] correspondences + mask."""
    n = pa.shape[0]
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    idx = _sample_indices(key, n, valid, cfg.num_hypotheses, 4)

    def fit(sample_idx):
        w = _onehot_weights(sample_idx, n)
        return solve_homography(pa, pb, w)

    hs = jax.vmap(fit)(idx)                                    # [HYP, 3, 3]
    finite = jnp.all(jnp.isfinite(hs.reshape(hs.shape[0], -1)), -1)

    def score(h):
        err = jnp.sum((apply_homography(h, pa) - pb) ** 2, -1)
        inl = (err < cfg.inlier_thresh ** 2) & valid
        return jnp.sum(inl.astype(jnp.int32))

    counts = jnp.where(finite, jax.vmap(score)(hs), -1)
    best = jnp.argmax(counts)
    h = hs[best]

    # IRLS refinement on the winner's inliers (reference ImproveHomography).
    def refine(h, _):
        err = jnp.sum((apply_homography(h, pa) - pb) ** 2, -1)
        w = ((err < cfg.inlier_thresh ** 2) & valid).astype(jnp.float32)
        h2 = solve_homography(pa, pb, w)
        # < 4 inliers under-determines H: the ridge term would "solve" it
        # to garbage; keep the previous estimate instead
        good = jnp.all(jnp.isfinite(h2)) & (jnp.sum(w) >= 4)
        return jnp.where(good, h2, h), None

    h, _ = jax.lax.scan(refine, h, None, length=cfg.refine_iters)
    err = jnp.sum((apply_homography(h, pa) - pb) ** 2, -1)
    inliers = (err < cfg.inlier_thresh ** 2) & valid
    num = jnp.sum(inliers.astype(jnp.int32))
    ok = (jnp.sum(valid.astype(jnp.int32)) >= cfg.min_matches) & (num >= 4)
    return HomographyResult(h=h, inliers=inliers, num_inliers=num, ok=ok)


@f32_matmuls
@partial(jax.jit, static_argnames=("iters",))
def improve_homography(h: jnp.ndarray, pa: jnp.ndarray, pb: jnp.ndarray,
                       valid: jnp.ndarray, thresh: float = 3.0,
                       iters: int = 5) -> jnp.ndarray:
    """Standalone IRLS polish of an existing homography.

    Reference API parity: ``ImproveHomography`` in geomFuncs.cpp
    (SURVEY.md C14) — repeated inlier re-selection under the current H
    followed by a weighted DLT solve.  ``find_homography`` runs the same
    loop internally; this entry point serves callers that bring their own
    initial H (e.g. a tracker's prediction).
    """

    def step(h, _):
        err = jnp.sum((apply_homography(h, pa) - pb) ** 2, -1)
        w = ((err < thresh ** 2) & valid).astype(jnp.float32)
        h2 = solve_homography(pa, pb, w)
        # < 4 inliers under-determines H; keep the previous estimate
        good = jnp.all(jnp.isfinite(h2)) & (jnp.sum(w) >= 4)
        return jnp.where(good, h2, h), None

    h, _ = jax.lax.scan(step, h, None, length=iters)
    return h


@f32_matmuls
@partial(jax.jit, static_argnames=("cfg",))
def find_rigid(pa: jnp.ndarray, pb: jnp.ndarray, valid: jnp.ndarray,
               cfg: RansacConfig = RansacConfig(),
               key: jax.Array | None = None) -> RigidResult:
    """RANSAC rigid transform (R, t) with R @ pa + t ≈ pb on [N, 3] points.

    The cuSIFT headline addition (SURVEY.md C15): RGB-D frame alignment from
    back-projected matches; 3-point Procrustes hypotheses + 3D inlier gate.
    """
    n = pa.shape[0]
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    idx = _sample_indices(key, n, valid, cfg.num_hypotheses, 3)

    def fit(sample_idx):
        w = _onehot_weights(sample_idx, n)
        return procrustes(pa, pb, w)

    rs, ts = jax.vmap(fit)(idx)                                # [HYP,3,3], [HYP,3]

    def score(r, t):
        err = jnp.sum((pa @ r.T + t - pb) ** 2, -1)
        inl = (err < cfg.inlier_thresh_3d ** 2) & valid
        return jnp.sum(inl.astype(jnp.int32))

    finite = jnp.all(jnp.isfinite(rs.reshape(rs.shape[0], -1)), -1)
    counts = jnp.where(finite, jax.vmap(score)(rs, ts), -1)
    best = jnp.argmax(counts)
    r, t = rs[best], ts[best]

    def refine(carry, _):
        r, t = carry
        err = jnp.sum((pa @ r.T + t - pb) ** 2, -1)
        w = ((err < cfg.inlier_thresh_3d ** 2) & valid).astype(jnp.float32)
        r2, t2 = procrustes(pa, pb, w)
        good = jnp.all(jnp.isfinite(r2)) & jnp.all(jnp.isfinite(t2)) & (jnp.sum(w) >= 3)
        return (jnp.where(good, r2, r), jnp.where(good, t2, t)), None

    (r, t), _ = jax.lax.scan(refine, (r, t), None, length=cfg.refine_iters)
    err = jnp.sum((pa @ r.T + t - pb) ** 2, -1)
    inliers = (err < cfg.inlier_thresh_3d ** 2) & valid
    num = jnp.sum(inliers.astype(jnp.int32))
    ok = (jnp.sum(valid.astype(jnp.int32)) >= cfg.min_matches) & (num >= 3)
    return RigidResult(r=r, t=t, inliers=inliers, num_inliers=num, ok=ok)
