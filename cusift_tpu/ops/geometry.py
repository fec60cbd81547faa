"""Geometry primitives: homographies, pinhole projection, Procrustes.

Reference analog: the hand-rolled per-thread linear algebra in
``ComputeHomographies`` / ``geomFuncs.cpp`` and the rigid-transform solve
(SURVEY.md C13–C15).  Here every solver is batched (vmap) and built from
`jnp.linalg` so it lowers to XLA-fused dense kernels.
"""

from __future__ import annotations

import jax.numpy as jnp
from cusift_tpu.utils.precision import f32_matmuls

from .mat3 import inv3, solve_spd


@f32_matmuls
def apply_homography(h: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Map [N, 2] points through a [3, 3] homography."""
    p = jnp.concatenate([pts, jnp.ones_like(pts[:, :1])], -1)
    q = p @ h.T
    return q[:, :2] / jnp.where(jnp.abs(q[:, 2:]) > 1e-12, q[:, 2:], 1e-12)


def masked_median(vals: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Median of vals[mask]; +inf-padded sort + middle index (static shape).

    Returns +inf when the mask is empty (callers gate on the count).
    """
    n = vals.shape[0]
    cnt = jnp.sum(mask.astype(jnp.int32))
    s = jnp.sort(jnp.where(mask, vals, jnp.inf))
    mid = jnp.clip((cnt - 1) // 2, 0, n - 1)
    return s[mid]


@f32_matmuls
def normalise_points(pts: jnp.ndarray, w: jnp.ndarray):
    """Hartley normalisation: zero-mean, mean length sqrt(2); weighted.

    Returns (normalised points, T [3,3]) with p_norm = T @ p.
    """
    wsum = jnp.maximum(jnp.sum(w), 1e-12)
    c = jnp.sum(pts * w[:, None], 0) / wsum
    d = jnp.sqrt(jnp.sum((pts - c) ** 2, -1))
    mean_d = jnp.sum(d * w) / wsum
    s = jnp.sqrt(2.0) / jnp.maximum(mean_d, 1e-12)
    t = jnp.array([[s, 0.0, -s * c[0]], [0.0, s, -s * c[1]], [0.0, 0.0, 1.0]])
    return (pts - c) * s, t


@f32_matmuls
def homography_rows(pa: jnp.ndarray, pb: jnp.ndarray):
    """DLT rows with h33 := 1: A [2N, 8], b [2N] such that A h8 = b."""
    n = pa.shape[0]
    xa, ya = pa[:, 0], pa[:, 1]
    xb, yb = pb[:, 0], pb[:, 1]
    z = jnp.zeros(n)
    o = jnp.ones(n)
    rx = jnp.stack([xa, ya, o, z, z, z, -xb * xa, -xb * ya], -1)
    ry = jnp.stack([z, z, z, xa, ya, o, -yb * xa, -yb * ya], -1)
    a = jnp.concatenate([rx, ry], 0)
    b = jnp.concatenate([xb, yb], 0)
    return a, b


@f32_matmuls
def solve_homography(pa: jnp.ndarray, pb: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Weighted least-squares homography (h33=1 gauge) with normalisation.

    pa, pb: [N, 2]; w: [N] weights. Minimal 4-point solves use w = one-hot.
    """
    pan, ta = normalise_points(pa, w)
    pbn, tb = normalise_points(pb, w)
    a, b = homography_rows(pan, pbn)
    ww = jnp.concatenate([w, w], 0)[:, None]
    ata = (a * ww).T @ a + 1e-10 * jnp.eye(8)
    atb = (a * ww).T @ b
    h8 = solve_spd(ata, atb)   # unrolled Cholesky: vmaps as elementwise math
    hn = jnp.concatenate([h8, jnp.ones(1)]).reshape(3, 3)
    h = inv3(tb) @ hn @ ta   # closed-form adjugate, no LU
    return h / jnp.where(jnp.abs(h[2, 2]) > 1e-12, h[2, 2], 1e-12)


@f32_matmuls
def procrustes(pa: jnp.ndarray, pb: jnp.ndarray, w: jnp.ndarray,
               iters: int = 16):
    """Weighted rigid fit R, t with R @ pa + t ≈ pb (no scale).

    Horn's quaternion method: R comes from the principal eigenvector of a
    symmetric 4x4 built from the cross-covariance, found by a statically
    unrolled shifted power iteration — elementwise math that vmaps over
    RANSAC's hypothesis batch, where the SVD form (Kabsch) would run 1024
    iterative 3x3 SVDs.  Equal accuracy, and it always yields a proper
    rotation (det = +1) with no reflection fix-up.

    pa, pb: [N, 3]; w: [N] non-negative weights.
    """
    wsum = jnp.maximum(jnp.sum(w), 1e-12)
    ca = jnp.sum(pa * w[:, None], 0) / wsum
    cb = jnp.sum(pb * w[:, None], 0) / wsum
    # Horn convention: S[i, j] = sum_n a_i b_j (A -> B rotation)
    s_ = ((pa - ca) * w[:, None]).T @ (pb - cb)       # [3, 3]
    r = rotation_from_cross_covariance(s_, iters)
    t = cb - r @ ca
    return r, t


@f32_matmuls
def rotation_from_cross_covariance(s_: jnp.ndarray,
                                   iters: int = 16) -> jnp.ndarray:
    """Rotation maximising tr(R S) from a 3x3 cross-covariance S.

    The quaternion-eigenvector core of Horn's method, shared by
    `procrustes` (S = weighted cross-covariance of two point clouds) and
    `ops/pnp.py` (nearest rotation to a projective 3x3: S = M^T).  Always
    a proper rotation; elementwise math that vmaps over hypothesis batches.
    """
    sxx, sxy, sxz = s_[0, 0], s_[0, 1], s_[0, 2]
    syx, syy, syz = s_[1, 0], s_[1, 1], s_[1, 2]
    szx, szy, szz = s_[2, 0], s_[2, 1], s_[2, 2]
    n = jnp.array([
        [sxx + syy + szz, syz - szy,       szx - sxz,       sxy - syx],
        [syz - szy,       sxx - syy - szz, sxy + syx,       szx + sxz],
        [szx - sxz,       sxy + syx,       syy - sxx - szz, syz + szy],
        [sxy - syx,       szx + sxz,       syz + szy,       szz - sxx - syy],
    ])
    # shift so the largest eigenvalue of N dominates in magnitude, then
    # square the matrix four times: one matvec then applies M^16, which
    # cures the slow convergence the conservative shift would otherwise
    # cause (the Frobenius shift compresses the relative eigengap)
    shift = jnp.sqrt(jnp.sum(n * n)) + 1e-12
    m = n / shift + jnp.eye(4)
    for _ in range(4):
        m = m @ m
        m = m / jnp.maximum(jnp.sqrt(jnp.sum(m * m)), 1e-20)
    q = jnp.full((4,), 0.5)
    for _ in range(iters):
        q = m @ q
        q = q / jnp.maximum(jnp.linalg.norm(q), 1e-20)
    qw, qx, qy, qz = q
    r = jnp.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)],
    ])
    return r


@f32_matmuls
def backproject(uv: jnp.ndarray, depth: jnp.ndarray, fx, fy, cx, cy) -> jnp.ndarray:
    """[N, 2] pixels + [N] depths -> [N, 3] camera-frame points."""
    x = (uv[:, 0] - cx) / fx * depth
    y = (uv[:, 1] - cy) / fy * depth
    return jnp.stack([x, y, depth], -1)


@f32_matmuls
def project(pts: jnp.ndarray, fx, fy, cx, cy) -> jnp.ndarray:
    """[N, 3] camera-frame points -> [N, 2] pixels (no distortion)."""
    z = jnp.where(jnp.abs(pts[:, 2]) > 1e-9, pts[:, 2], 1e-9)
    return jnp.stack([pts[:, 0] / z * fx + cx, pts[:, 1] / z * fy + cy], -1)
