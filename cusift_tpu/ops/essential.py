"""Essential-matrix RANSAC + two-view monocular geometry.

New surface relative to the reference (SURVEY.md §0: cuSIFT stops at
homography + RGB-D rigid RANSAC, both depth-assisted); this module makes
the depth-free BASELINE configs[4] (KITTI monocular odometry) reachable:

* batched normalised-8-point hypotheses in the exact shape of
  ``ops/ransac.py:find_homography`` (one `vmap` over static one-hot
  minimal samples — the batched analog of the reference's
  thread-per-hypothesis ``ComputeHomographies`` kernel, SURVEY.md C13);
* the 9x9 null-space solve is an inverse power iteration on the
  ridge-regularised normal matrix using the statically-unrolled Cholesky
  (`ops/mat3.py:solve_spd`) — elementwise math that vmaps over the
  hypothesis batch (no batched SVD, which lowers to iterative kernels);
* Sampson-error scoring, IRLS re-solve on the winner's inliers;
* closed-form decomposition into (R, t) with a cheirality vote over all
  four candidates via batched midpoint triangulation.

All coordinates are NORMALISED camera coordinates (pixels through K^-1);
thresholds are in normalised units (pixels / focal length).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from cusift_tpu.utils.precision import f32_matmuls

from ..config import RansacConfig
from .geometry import normalise_points
from .mat3 import solve_spd
from .ransac import _onehot_weights, _sample_indices


class EssentialResult(NamedTuple):
    e: jnp.ndarray            # [3, 3] essential matrix (xb^T E xa = 0)
    r: jnp.ndarray            # [3, 3] rotation with xb ~ R xa + t
    t: jnp.ndarray            # [3] unit-norm translation (scale-free)
    inliers: jnp.ndarray      # [N] bool
    num_inliers: jnp.ndarray  # int32
    ok: jnp.ndarray           # bool


def _essential_rows(xa: jnp.ndarray, xb: jnp.ndarray) -> jnp.ndarray:
    """[N, 9] epipolar-constraint rows: row . vec(E) = xb^T E xa."""
    ax, ay = xa[:, 0], xa[:, 1]
    bx, by = xb[:, 0], xb[:, 1]
    o = jnp.ones_like(ax)
    return jnp.stack([bx * ax, bx * ay, bx,
                      by * ax, by * ay, by,
                      ax, ay, o], -1)


@f32_matmuls
def solve_essential(xa: jnp.ndarray, xb: jnp.ndarray,
                    w: jnp.ndarray) -> jnp.ndarray:
    """Weighted 8-point essential matrix from [N, 2] normalised coords.

    Hartley-normalises both sides, forms the 9x9 normal matrix of the
    epipolar rows and extracts its least eigenvector by shifted inverse
    power iteration (each step one unrolled 9x9 Cholesky solve).  For a
    minimal 8-point sample the null space is exact, so 4 iterations
    converge to machine precision; degenerate samples yield garbage that
    RANSAC scoring discards (same contract as `solve_homography`).
    """
    xan, ta = normalise_points(xa, w)
    xbn, tb = normalise_points(xb, w)
    a = _essential_rows(xan, xbn)                        # [N, 9]
    ata = (a * w[:, None]).T @ a
    # 1e-6 ridge: enough f32 headroom that the near-singular Cholesky of a
    # minimal sample cannot overflow (a 1e-9 ridge collapsed some solves
    # to exact zeros, which scoring would accept vacuously)
    ata = ata + 1e-6 * jnp.trace(ata) * jnp.eye(9)
    # fixed full-rank start; components along the null space dominate
    # after one solve, the remaining iterations polish.  Keep the previous
    # iterate whenever a solve degenerates (overflow/underflow).
    v = jnp.full((9,), 1.0 / 3.0)
    for _ in range(4):
        v2 = solve_spd(ata, v)
        nrm = jnp.linalg.norm(v2)
        good = jnp.isfinite(nrm) & (nrm > 1e-20)
        v = jnp.where(good, v2 / jnp.where(good, nrm, 1.0), v)
    en = v.reshape(3, 3)
    e = tb.T @ en @ ta                                   # denormalise
    return e / jnp.maximum(jnp.linalg.norm(e), 1e-20)


def sampson_error(e: jnp.ndarray, xa: jnp.ndarray,
                  xb: jnp.ndarray) -> jnp.ndarray:
    """First-order geometric (Sampson) epipolar error, [N]."""
    pa = jnp.concatenate([xa, jnp.ones_like(xa[:, :1])], -1)   # [N, 3]
    pb = jnp.concatenate([xb, jnp.ones_like(xb[:, :1])], -1)
    ea = pa @ e.T                                              # E  xa -> [N, 3]
    eb = pb @ e                                                # E^T xb
    num = jnp.sum(pb * ea, -1) ** 2
    den = ea[:, 0] ** 2 + ea[:, 1] ** 2 + eb[:, 0] ** 2 + eb[:, 1] ** 2
    return num / jnp.maximum(den, 1e-18)


@f32_matmuls
def triangulate_midpoint(r: jnp.ndarray, t: jnp.ndarray,
                         xa: jnp.ndarray, xb: jnp.ndarray):
    """Midpoint triangulation for xb ~ R xa + t.

    Rays: camera A at the origin with directions (xa, 1); camera B's
    centre in the A frame is c = -R^T t with directions R^T (xb, 1).
    Minimising ||za*da - (c + zb*db)||^2 is a closed-form 2x2 solve per
    correspondence — elementwise math, the "small dense solves stay
    unrolled" pattern of ops/mat3.py.

    Returns (points [N, 3] in the A frame, depth_a [N], depth_b [N]);
    depths are the z-coordinates in their own camera (cheirality test).
    """
    da = jnp.concatenate([xa, jnp.ones_like(xa[:, :1])], -1)   # [N, 3]
    db = jnp.concatenate([xb, jnp.ones_like(xb[:, :1])], -1) @ r  # R^T rows
    c = -(r.T @ t)                                             # [3]
    daa = jnp.sum(da * da, -1)
    dbb = jnp.sum(db * db, -1)
    dab = jnp.sum(da * db, -1)
    dac = da @ c
    dbc = db @ c
    det = daa * dbb - dab * dab
    det = jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    za = (dac * dbb - dbc * dab) / det
    zb = (dac * dab - dbc * daa) / det
    pts = 0.5 * (za[:, None] * da + c[None, :] + zb[:, None] * db)
    return pts, za, zb


@f32_matmuls
def decompose_essential(e: jnp.ndarray, xa: jnp.ndarray, xb: jnp.ndarray,
                        w: jnp.ndarray):
    """(R, t) from E with a cheirality vote over the four candidates.

    The single winner matrix affords one true 3x3 SVD (not vmapped, so
    the iterative SVD cost is paid once, unlike the hypothesis batch).
    Returns (r, t, n_good) where n_good is the winning candidate's count
    of correspondences triangulating in front of BOTH cameras.
    """
    u, _, vt = jnp.linalg.svd(e)
    u = u * jnp.sign(jnp.linalg.det(u))
    vt = vt * jnp.sign(jnp.linalg.det(vt))
    wm = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    r1 = u @ wm @ vt
    r2 = u @ wm.T @ vt
    tu = u[:, 2]
    rs = jnp.stack([r1, r1, r2, r2])
    ts = jnp.stack([tu, -tu, tu, -tu])

    def count(r, t):
        _, za, zb = triangulate_midpoint(r, t, xa, xb)
        return jnp.sum((w > 0) & (za > 1e-6) & (zb > 1e-6))

    counts = jax.vmap(count)(rs, ts)
    best = jnp.argmax(counts)
    return rs[best], ts[best], counts[best]


@f32_matmuls
@partial(jax.jit, static_argnames=("cfg",))
def find_essential(xa: jnp.ndarray, xb: jnp.ndarray, valid: jnp.ndarray,
                   cfg: RansacConfig = RansacConfig(),
                   key: jax.Array | None = None) -> EssentialResult:
    """RANSAC essential matrix over [N, 2] normalised correspondences.

    Same orchestration as `find_homography` (SURVEY.md C13 analog):
    static hypothesis batch -> vmapped solves -> broadcast scoring ->
    IRLS polish -> decomposition with cheirality vote.
    """
    n = xa.shape[0]
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    idx = _sample_indices(key, n, valid, cfg.num_hypotheses, 8)

    def fit(sample_idx):
        return solve_essential(xa, xb, _onehot_weights(sample_idx, n))

    es = jax.vmap(fit)(idx)                                  # [HYP, 3, 3]
    flat = es.reshape(es.shape[0], -1)
    # reject non-finite AND near-zero hypotheses: E = 0 makes the Sampson
    # numerator vacuously zero for every correspondence
    finite = (jnp.all(jnp.isfinite(flat), -1)
              & (jnp.linalg.norm(flat, axis=-1) > 0.5))
    th2 = cfg.inlier_thresh_epi ** 2

    def score(e):
        inl = (sampson_error(e, xa, xb) < th2) & valid
        return jnp.sum(inl.astype(jnp.int32))

    counts = jnp.where(finite, jax.vmap(score)(es), -1)
    e = es[jnp.argmax(counts)]

    def refine(e, _):
        w = ((sampson_error(e, xa, xb) < th2) & valid).astype(jnp.float32)
        e2 = solve_essential(xa, xb, w)
        good = (jnp.all(jnp.isfinite(e2)) & (jnp.linalg.norm(e2) > 0.5)
                & (jnp.sum(w) >= 8))
        return jnp.where(good, e2, e), None

    e, _ = jax.lax.scan(refine, e, None, length=cfg.refine_iters)
    inliers = (sampson_error(e, xa, xb) < th2) & valid
    num = jnp.sum(inliers.astype(jnp.int32))

    r, t, n_good = decompose_essential(e, xa, xb,
                                       inliers.astype(jnp.float32))
    ok = ((jnp.sum(valid.astype(jnp.int32)) >= cfg.min_matches)
          & (num >= 8) & (n_good >= num // 2))
    return EssentialResult(e=e, r=r, t=t, inliers=inliers,
                           num_inliers=num, ok=ok)
