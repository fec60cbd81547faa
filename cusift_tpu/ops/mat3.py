"""Closed-form 3x3 linear algebra (det / inverse / solve).

`jnp.linalg.inv` lowers through a general LU factorisation — a poor fit for
huge batches of tiny matrices (compile-time and runtime overhead).
Cofactor expansion is ~30 fused elementwise flops per matrix and vectorises over any
leading batch dims.  Used by the DoG quadratic refinement (ops/detect.py)
and the landmark-block inverses in BA (optim/ba.py).
"""

from __future__ import annotations

import jax.numpy as jnp
from cusift_tpu.utils.precision import f32_matmuls


def det3(m: jnp.ndarray) -> jnp.ndarray:
    """Determinant of [..., 3, 3]."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]))


def adjugate3(m: jnp.ndarray) -> jnp.ndarray:
    """Adjugate (transposed cofactor matrix) of [..., 3, 3]."""
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c02 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c10 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c20 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    c21 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    return jnp.stack([
        jnp.stack([c00, c01, c02], -1),
        jnp.stack([c10, c11, c12], -1),
        jnp.stack([c20, c21, c22], -1),
    ], -2)


@f32_matmuls
def inv3(m: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Inverse of [..., 3, 3]; singular inputs return adj/eps-guarded det."""
    d = det3(m)[..., None, None]
    d = jnp.where(jnp.abs(d) > eps, d, jnp.where(d >= 0, eps, -eps))
    return adjugate3(m) / d


@f32_matmuls
def solve3(m: jnp.ndarray, b: jnp.ndarray, eps: float = 1e-12):
    """Solve m x = b for [..., 3, 3] x [..., 3]; returns (x, ok)."""
    d = det3(m)
    ok = jnp.abs(d) > eps
    dd = jnp.where(ok, d, 1.0)
    x = (adjugate3(m) @ b[..., None])[..., 0] / dd[..., None]
    return jnp.where(ok[..., None], x, 0.0), ok


def solve_spd(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = b for small SPD A [..., n, n] via unrolled Cholesky.

    Statically unrolled over n (intended n <= ~10): every step is an
    elementwise op over the batch, so a vmapped 1024-hypothesis RANSAC
    solve stays elementwise math instead of `jnp.linalg.solve`'s batched
    LU.  Callers must regularise A
    (ridge) so positive-definiteness holds; degenerate systems produce
    finite garbage that downstream scoring rejects.
    """
    n = a.shape[-1]
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                l[i][j] = jnp.sqrt(jnp.maximum(s, 1e-20))
            else:
                l[i][j] = s / l[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return jnp.stack(x, -1)


@f32_matmuls
def inv3_spd(a: jnp.ndarray, rel_floor: float = 3e-7) -> jnp.ndarray:
    """Inverse of PSD [..., 3, 3] via closed-form Cholesky (stable in f32).

    The cofactor inverse (inv3) is catastrophically wrong in f32 past
    condition ~1e7: the determinant is a difference of entry products, so
    its absolute error is ~eps * ||a||^3, which swamps a small true
    determinant and can flip its sign — measured on a thin-ray BA
    landmark block (condition 3e8): true ||inv|| ~3e3, cofactor ~5e21.
    Cholesky is backward stable; pivot squares are clamped to rel_floor
    times the largest diagonal entry, so f32 cancellation in the pivot
    update acts as bounded extra damping of the (unobservable) thin
    direction instead of a blow-up: ||inv|| <= 1/(rel_floor * max_diag).
    rel_floor ~ 3e-7 sits at the f32 cancellation noise level itself —
    the tightest floor that is numerically meaningful.
    """
    d11, d22, d33 = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    floor = rel_floor * jnp.maximum(d11, jnp.maximum(d22, d33)) + 1e-30
    l11 = jnp.sqrt(jnp.maximum(d11, floor))
    l21 = a[..., 1, 0] / l11
    l31 = a[..., 2, 0] / l11
    l22 = jnp.sqrt(jnp.maximum(d22 - l21 * l21, floor))
    l32 = (a[..., 2, 1] - l31 * l21) / l22
    l33 = jnp.sqrt(jnp.maximum(d33 - l31 * l31 - l32 * l32, floor))
    m11 = 1.0 / l11
    m22 = 1.0 / l22
    m33 = 1.0 / l33
    m21 = -l21 * m11 * m22
    m31 = (l21 * l32 - l22 * l31) * m11 * m22 * m33
    m32 = -l32 * m22 * m33
    i11 = m11 * m11 + m21 * m21 + m31 * m31
    i12 = m21 * m22 + m31 * m32
    i13 = m31 * m33
    i22 = m22 * m22 + m32 * m32
    i23 = m32 * m33
    i33 = m33 * m33
    return jnp.stack([jnp.stack([i11, i12, i13], -1),
                      jnp.stack([i12, i22, i23], -1),
                      jnp.stack([i13, i23, i33], -1)], -2)
