"""Batched DLT-PnP RANSAC: 3D map landmarks -> camera pose at map scale.

New surface relative to the reference (SURVEY.md §0: cuSIFT's estimators
stop at homography + RGB-D rigid RANSAC): monocular localisation against
a persistent landmark map needs perspective-n-point.  Chaining per-pair
essential-matrix scales random-walks multiplicatively (62f0428:BASELINE.md round-3
drift campaign); PnP against landmarks that persist across many frames is
the structural fix — each pose is measured at MAP scale directly.

Design, same recipe as `ops/essential.py`:

* minimal 6-point hypotheses solved by the projective DLT — the 12x12
  normal-matrix null space via shifted inverse power iteration on the
  statically-unrolled Cholesky (`ops/mat3.py:solve_spd`), which vmaps
  over the hypothesis batch as elementwise math (no batched SVD);
* rotation extracted from the projective 3x4 by Horn's quaternion method
  (`ops/geometry.py:rotation_from_cross_covariance` — the nearest
  rotation to M maximises tr(R^T M), the same eigenproblem as the
  point-cloud cross-covariance);
* reprojection-error scoring in normalised camera coordinates with a
  cheirality gate, IRLS re-solve on the winner's inliers.

Coordinates: `pts` are world-frame 3D landmarks, `xy` are NORMALISED
camera coordinates (pixels through K^-1); the result is world-to-camera
(x_cam = R x_w + t).  Thresholds are in normalised units.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from cusift_tpu.utils.precision import f32_matmuls

from ..config import RansacConfig
from .geometry import normalise_points, rotation_from_cross_covariance
from .mat3 import inv3, solve_spd
from .ransac import _onehot_weights, _sample_indices


class PnPResult(NamedTuple):
    r: jnp.ndarray            # [3, 3] world-to-camera rotation
    t: jnp.ndarray            # [3] translation at MAP scale
    inliers: jnp.ndarray      # [N] bool
    num_inliers: jnp.ndarray  # int32
    ok: jnp.ndarray           # bool


def _normalise_points3(pts: jnp.ndarray, w: jnp.ndarray):
    """Hartley conditioning for [N, 3] points: centroid 0, RMS sqrt(3).

    Returns (normalised points, 4x4 T with X_n = T X_h).
    """
    wsum = jnp.maximum(jnp.sum(w), 1e-12)
    c = jnp.sum(pts * w[:, None], 0) / wsum
    d = jnp.sqrt(jnp.sum((pts - c) ** 2, -1))
    s = jnp.sqrt(3.0) / jnp.maximum(jnp.sum(d * w) / wsum, 1e-12)
    t = jnp.zeros((4, 4)).at[0, 0].set(s).at[1, 1].set(s).at[2, 2].set(s) \
        .at[3, 3].set(1.0).at[:3, 3].set(-s * c)
    return (pts - c) * s, t


def _dlt_rows(pts: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """[2N, 12] projective-DLT rows: row . vec(P) = 0 for x ~ P X."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    u, v = xy[:, 0], xy[:, 1]
    o = jnp.ones_like(x)
    zr = jnp.zeros_like(x)
    r1 = jnp.stack([x, y, z, o, zr, zr, zr, zr,
                    -u * x, -u * y, -u * z, -u], -1)
    r2 = jnp.stack([zr, zr, zr, zr, x, y, z, o,
                    -v * x, -v * y, -v * z, -v], -1)
    return jnp.concatenate([r1, r2], 0)


@f32_matmuls
def solve_pnp(pts: jnp.ndarray, xy: jnp.ndarray,
              w: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Weighted DLT perspective-n-point from [N, 3] + [N, 2] normalised.

    Returns (r, t) with x_cam ~ R x_w + t (t at map scale).  Minimal
    6-point samples have an exact null space, so 4 inverse-power
    iterations converge to machine precision; degenerate samples yield
    garbage that RANSAC scoring discards (contract of `solve_essential`).
    """
    ptsn, t3 = _normalise_points3(pts, w)
    xyn, t2 = normalise_points(xy, w)
    a = _dlt_rows(ptsn, xyn)                              # [2N, 12]
    ww = jnp.concatenate([w, w], 0)
    ata = (a * ww[:, None]).T @ a
    ata = ata + 1e-6 * jnp.trace(ata) * jnp.eye(12)
    v = jnp.full((12,), 1.0 / 3.0)
    for _ in range(4):
        v2 = solve_spd(ata, v)
        nrm = jnp.linalg.norm(v2)
        good = jnp.isfinite(nrm) & (nrm > 1e-20)
        v = jnp.where(good, v2 / jnp.where(good, nrm, 1.0), v)
    pn = v.reshape(3, 4)
    p = inv3(t2) @ pn @ t3                                # denormalise
    # sign: depths of the weighted points must be positive
    ph = jnp.concatenate([pts, jnp.ones_like(pts[:, :1])], -1)
    z = ph @ p[2]
    p = p * jnp.where(jnp.sum(jnp.sign(z) * w) < 0, -1.0, 1.0)
    m = p[:, :3]
    r = rotation_from_cross_covariance(m.T)               # nearest rotation
    s = jnp.trace(r.T @ m) / 3.0
    t = p[:, 3] / jnp.where(jnp.abs(s) > 1e-12, s, 1e-12)
    return r, t


def reprojection_error2(r: jnp.ndarray, t: jnp.ndarray, pts: jnp.ndarray,
                        xy: jnp.ndarray):
    """Squared normalised reprojection error [N] + camera-frame depth [N]."""
    pc = pts @ r.T + t
    z = pc[:, 2]
    proj = pc[:, :2] / jnp.maximum(jnp.abs(z), 1e-9)[:, None] \
        * jnp.sign(jnp.where(z == 0, 1.0, z))[:, None]
    err = jnp.sum((proj - xy) ** 2, -1)
    return err, z


@f32_matmuls
@partial(jax.jit, static_argnames=("cfg",))
def find_pnp(pts: jnp.ndarray, xy: jnp.ndarray, valid: jnp.ndarray,
             cfg: RansacConfig = RansacConfig(),
             key: jax.Array | None = None,
             init: tuple | None = None) -> PnPResult:
    """RANSAC PnP over [N, 3] world landmarks / [N, 2] normalised coords.

    Same orchestration as `find_essential` with three robustness twists
    tuned for the monocular map-tracking workload (landmarks triangulated
    at low parallax carry coherent depth noise that a MINIMAL 6-point DLT
    amplifies into garbage hypotheses — measured on the two-plane scene):

    * NON-minimal samples (`pnp_sample_size`, default 12) average the
      per-point noise down inside each hypothesis solve;
    * one extra hypothesis solves over ALL valid correspondences (the
      ratio-test prefilter keeps the outlier rate low, so the all-in DLT
      is usually already close);
    * MSAC scoring (truncated squared error, argmin of cost) ranks
      near-miss hypotheses smoothly where strict inlier counting returns
      0 for every hypothesis and argmax picks noise;
    * graduated IRLS: the re-solve threshold anneals 3x -> 1x so a
      coarse-but-right winner pulls in its true support before the final
      strict gate;
    * optional `init` pose (r0, t0) joins the hypothesis pool — the
      LO-RANSAC motion prior: a tracking caller's constant-velocity /
      chain candidate usually beats every sampled DLT when translation is
      weakly observable, and MSAC selects it on merit;
    * the refined model is kept only if it does not RAISE the MSAC cost
      over the selected hypothesis (the DLT re-solve can wander along the
      weak translation direction).
    """
    n = pts.shape[0]
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    idx = _sample_indices(key, n, valid, cfg.num_hypotheses - 1,
                          cfg.pnp_sample_size)

    def fit(sample_idx):
        return solve_pnp(pts, xy, _onehot_weights(sample_idx, n))

    rs, ts = jax.vmap(fit)(idx)                     # [HYP-1, 3, 3] / [.., 3]
    r_all, t_all = solve_pnp(pts, xy, valid.astype(jnp.float32))
    rs = jnp.concatenate([rs, r_all[None]], 0)
    ts = jnp.concatenate([ts, t_all[None]], 0)
    if init is not None:
        rs = jnp.concatenate([rs, init[0][None]], 0)
        ts = jnp.concatenate([ts, init[1][None]], 0)
    finite = (jnp.all(jnp.isfinite(rs.reshape(rs.shape[0], -1)), -1)
              & jnp.all(jnp.isfinite(ts), -1))
    th2 = cfg.inlier_thresh_pnp ** 2

    def msac_cost(r, t):
        err, z = reprojection_error2(r, t, pts, xy)
        e = jnp.where(z > 1e-6, err, jnp.inf)
        return jnp.sum(jnp.where(valid, jnp.minimum(e, th2), 0.0))

    costs = jnp.where(finite, jax.vmap(msac_cost)(rs, ts), jnp.inf)
    best = jnp.argmin(costs)
    r, t = rs[best], ts[best]

    def refine(rt, f):
        r, t = rt
        err, z = reprojection_error2(r, t, pts, xy)
        w = ((err < f * f * th2) & (z > 1e-6) & valid).astype(jnp.float32)
        r2, t2 = solve_pnp(pts, xy, w)
        good = (jnp.all(jnp.isfinite(r2)) & jnp.all(jnp.isfinite(t2))
                & (jnp.sum(w) >= 6))
        return (jnp.where(good, r2, r), jnp.where(good, t2, t)), None

    anneal = jnp.linspace(3.0, 1.0, max(cfg.refine_iters, 2))
    (r2, t2), _ = jax.lax.scan(refine, (r, t), anneal)
    worse = msac_cost(r2, t2) > costs[best]
    r = jnp.where(worse, r, r2)
    t = jnp.where(worse, t, t2)
    err, z = reprojection_error2(r, t, pts, xy)
    inliers = (err < th2) & (z > 1e-6) & valid
    num = jnp.sum(inliers.astype(jnp.int32))
    ok = ((jnp.sum(valid.astype(jnp.int32)) >= cfg.min_matches)
          & (num >= 6))
    return PnPResult(r=r, t=t, inliers=inliers, num_inliers=num, ok=ok)
