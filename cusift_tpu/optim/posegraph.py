"""Pose-graph optimisation (SE(3) graph SLAM backend).

New surface relative to the reference (SURVEY.md §0): the SLAM backend
optimises keyframe poses against relative-pose constraints (odometry + loop
closures).  Residual per edge (i, j):

    r_e = log( T_meas^-1 · T_i · T_j^-1 )      for world-to-cam T

Matrix-free Gauss-Newton: J v and J^T u come from `jax.jvp` / `jax.vjp` of
the whole residual map (no sparse matrices), so the normal equations
(J^T J + lambda I) dx = -J^T r are solved by CG with only O(E) work per
iteration — the accelerator-friendly analog of a sparse Cholesky backend.  The
trajectory-partitioned distributed variant (SURVEY.md §2.4 D5) reuses the
same residual map inside shard_map.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from cusift_tpu.utils.precision import f32_matmuls

from . import robust

from ..config import PoseGraphConfig
from .lie import compose, inverse, se3_exp, se3_log


class PoseGraph(NamedTuple):
    """Static-capacity pose graph; edge weight 0 disables an edge."""

    poses_r: jnp.ndarray   # [N, 3, 3] world-to-camera
    poses_t: jnp.ndarray   # [N, 3]
    edge_i: jnp.ndarray    # [E] int32
    edge_j: jnp.ndarray    # [E] int32
    meas_r: jnp.ndarray    # [E, 3, 3] measured T_i * T_j^-1
    meas_t: jnp.ndarray    # [E, 3]
    weight: jnp.ndarray    # [E] (sqrt-information scalar)


class PoseGraphResult(NamedTuple):
    poses_r: jnp.ndarray
    poses_t: jnp.ndarray
    cost: jnp.ndarray
    initial_cost: jnp.ndarray


def _residuals(xi: jnp.ndarray, g: PoseGraph) -> jnp.ndarray:
    """[E, 6] weighted residuals at retraction xi [N, 6] about g's poses."""
    dr, dt = se3_exp(xi)
    r = dr @ g.poses_r
    t = (dr @ g.poses_t[..., None])[..., 0] + dt
    ri, ti = r[g.edge_i], t[g.edge_i]
    rj, tj = r[g.edge_j], t[g.edge_j]
    # relative transform T_i * T_j^-1
    rji, tji = inverse(rj, tj)
    rrel, trel = compose(ri, ti, rji, tji)
    # error vs measurement
    rmi, tmi = inverse(g.meas_r, g.meas_t)
    rerr, terr = compose(rmi, tmi, rrel, trel)
    return se3_log(rerr, terr) * g.weight[:, None]


@f32_matmuls
def cost(g: PoseGraph, axis_name=None) -> jnp.ndarray:
    """Total weighted cost; with `axis_name`, g's edges are the local
    shard and the scalar is psum-reduced (SURVEY.md §2.4 D5)."""
    r = _residuals(jnp.zeros((g.poses_r.shape[0], 6)), g)
    c = 0.5 * jnp.sum(r ** 2)
    return jax.lax.psum(c, axis_name) if axis_name is not None else c


def _edge_norms(g: PoseGraph) -> jnp.ndarray:
    """UNWEIGHTED per-edge residual norms at the current poses.

    The stored residuals carry the sqrt-information weight; dividing it
    out keeps the robust kernel's scale in residual units, so a weight-2
    loop edge (confidence) is not pushed toward the outlier regime at
    half the residual of an odometry edge.
    """
    r = _residuals(jnp.zeros((g.poses_r.shape[0], 6)), g)
    return jnp.linalg.norm(r, axis=-1) / jnp.maximum(g.weight, 1e-12)


def _robust_cost(g: PoseGraph, delta: float, kernel: str,
                 axis_name=None) -> jnp.ndarray:
    """Robust cost on per-edge residual norms (delta <= 0: plain L2)."""
    if delta <= 0:
        return cost(g, axis_name)
    # information-weighted robust cost: sum_e w_e^2 rho(||r_e||_unweighted)
    # (reduces exactly to cost() when delta <= 0)
    c = jnp.sum(g.weight ** 2 * robust.rho(_edge_norms(g), delta, kernel))
    return jax.lax.psum(c, axis_name) if axis_name is not None else c


def _edge_residual_12(xi2, ri, ti, rj, tj, mr, mt, w):
    """One edge's weighted residual [6] at a 12-dim endpoint retraction.

    Same math as `_residuals`, restricted to a single edge so its dense
    [6, 12] Jacobian (via jacfwd) only touches the two endpoint poses —
    the sparse structure the dense normal-equation assembly exploits.
    """
    dri, dti = se3_exp(xi2[:6])
    drj, dtj = se3_exp(xi2[6:])
    ri2, ti2 = compose(dri, dti, ri, ti)
    rj2, tj2 = compose(drj, dtj, rj, tj)
    rji, tji = inverse(rj2, tj2)
    rrel, trel = compose(ri2, ti2, rji, tji)
    rmi, tmi = inverse(mr, mt)
    rerr, terr = compose(rmi, tmi, rrel, trel)
    return se3_log(rerr, terr) * w


def _assemble_dense(g_it: PoseGraph, n: int):
    """Dense Gauss-Newton system (H [6n, 6n], b [6n]) from per-edge blocks.

    Per-edge [6, 12] Jacobians (vmapped jacfwd — one batched pass) are
    scatter-added into the four (i, j) pose blocks.  For the keyframe-ring
    graph sizes the streaming loop solves (n <= 256, E <= a few hundred)
    this replaces the matrix-free CG path's ~max_iters*cg_iters sequential
    matvecs (pure program latency) with a handful of batched ops per LM
    iteration.
    """
    zero12 = jnp.zeros(12)
    ri, ti = g_it.poses_r[g_it.edge_i], g_it.poses_t[g_it.edge_i]
    rj, tj = g_it.poses_r[g_it.edge_j], g_it.poses_t[g_it.edge_j]
    res = jax.vmap(_edge_residual_12,
                   in_axes=(None, 0, 0, 0, 0, 0, 0, 0))(
        zero12, ri, ti, rj, tj, g_it.meas_r, g_it.meas_t, g_it.weight)
    jac = jax.vmap(jax.jacfwd(_edge_residual_12),
                   in_axes=(None, 0, 0, 0, 0, 0, 0, 0))(
        zero12, ri, ti, rj, tj, g_it.meas_r, g_it.meas_t, g_it.weight)
    ji, jj = jac[..., :6], jac[..., 6:]                       # [E, 6, 6]
    h = jnp.zeros((n, n, 6, 6))
    h = h.at[g_it.edge_i, g_it.edge_i].add(
        jnp.einsum("eab,eac->ebc", ji, ji))
    h = h.at[g_it.edge_i, g_it.edge_j].add(
        jnp.einsum("eab,eac->ebc", ji, jj))
    h = h.at[g_it.edge_j, g_it.edge_i].add(
        jnp.einsum("eab,eac->ebc", jj, ji))
    h = h.at[g_it.edge_j, g_it.edge_j].add(
        jnp.einsum("eab,eac->ebc", jj, jj))
    b = jnp.zeros((n, 6))
    b = b.at[g_it.edge_i].add(-jnp.einsum("eab,ea->eb", ji, res))
    b = b.at[g_it.edge_j].add(-jnp.einsum("eab,ea->eb", jj, res))
    return (h.transpose(0, 2, 1, 3).reshape(n * 6, n * 6), b.reshape(-1))


def _cg(matvec, b, iters: int, tol: float):
    x = jnp.zeros_like(b)
    r = b
    p = r
    rs = jnp.sum(r * r)
    bn = jnp.maximum(jnp.sqrt(jnp.sum(b * b)), 1e-30)

    def body(carry, _):
        x, r, p, rs = carry
        ap = matvec(p)
        denom = jnp.sum(p * ap)
        alpha = jnp.where(jnp.abs(denom) > 1e-30, rs / denom, 0.0)
        x2 = x + alpha * p
        r2 = r - alpha * ap
        rs2 = jnp.sum(r2 * r2)
        beta = jnp.where(rs > 1e-30, rs2 / rs, 0.0)
        p2 = r2 + beta * p
        return (x2, r2, p2, rs2), None

    (x, _, _, _), _ = jax.lax.scan(body, (x, r, p, rs), None, length=iters)
    return x


@f32_matmuls
def lm_loop(g: PoseGraph, cfg: PoseGraphConfig,
            axis_name=None) -> PoseGraphResult:
    """LM on the pose graph; gauge fixed by freezing pose 0 (optional).

    Runs standalone (axis_name=None) or inside shard_map with poses
    replicated and edges sharded over `axis_name` — the trajectory-
    partitioned distributed pose graph of SURVEY.md §2.4 D5: each device
    owns a contiguous keyframe chunk's edges, cross-chunk constraint
    contributions (the [N, 6] J^T r / J^T J x vectors) ride one psum per
    application, and every device runs the identical replicated CG, so
    the distributed result is bit-for-bit the single-device math.
    """
    n = g.poses_r.shape[0]
    mask = jnp.ones((n, 6))
    if cfg.fix_first_pose:
        mask = mask.at[0].set(0.0)
    # dense normal-equation solve is single-device only: the distributed
    # form's edges are sharded and H assembly would need an O(n^2) psum
    dense = cfg.solver == "dense" and axis_name is None

    def psum_(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x

    delta = cfg.huber_delta

    def body(carry, _):
        g, lam, cur = carry
        zero = jnp.zeros((n, 6))
        if delta > 0:
            # IRLS: sqrt-Huber edge reweighting at the current poses;
            # acceptance evaluates the true robust cost (one objective)
            w_rob = robust.sqrt_weight(_edge_norms(g), delta,
                                       cfg.robust_kernel)
            g_it = g._replace(weight=g.weight * w_rob)
        else:
            g_it = g
        if dense:
            h, b = _assemble_dense(g_it, n)
            # free dofs: not gauge-fixed AND actually constrained (padded
            # ring slots / weight-0 edges leave zero diagonal blocks that
            # would sink the f32 Cholesky's conditioning).  Fixed/dead
            # dofs get a unit diagonal and zero rhs => dx = 0 there.
            free = (mask.reshape(-1) > 0) & (jnp.diag(h) > 1e-12)
            hm = jnp.where(free[:, None] & free[None, :], h, 0.0)
            hm = hm + jnp.diag(jnp.where(free, lam, 1.0))
            bm = jnp.where(free, b, 0.0)
            chol = jax.scipy.linalg.cho_factor(hm, lower=True)
            dx = jax.scipy.linalg.cho_solve(chol, bm).reshape(n, 6) * mask
        else:
            res0, vjp_fn = jax.vjp(lambda xi: _residuals(xi, g_it), zero)

            def normal_mv(x):
                x = x * mask
                _, jx = jax.jvp(lambda xi: _residuals(xi, g_it), (zero,),
                                (x,))
                jtjx = psum_(vjp_fn(jx)[0])
                return (jtjx + lam * x) * mask

            b = -psum_(vjp_fn(res0)[0]) * mask
            dx = _cg(normal_mv, b, cfg.cg_iters, cfg.cg_tol) * mask
        dr, dt = se3_exp(dx)
        r2 = dr @ g.poses_r
        t2 = (dr @ g.poses_t[..., None])[..., 0] + dt
        cand = g._replace(poses_r=r2, poses_t=t2)
        cnew = _robust_cost(cand, delta, cfg.robust_kernel,
                             axis_name)
        accept = jnp.isfinite(cnew) & (cnew < cur)
        g2 = jax.tree.map(lambda a, b: jnp.where(accept, b, a), g, cand)
        lam2 = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6)
        return (g2, lam2, jnp.where(accept, cnew, cur)), None

    c0 = _robust_cost(g, delta, cfg.robust_kernel, axis_name)
    init = (g, jnp.asarray(cfg.init_damping, jnp.float32), c0)
    (gf, _, cf), _ = jax.lax.scan(body, init, None, length=cfg.max_iters)
    return PoseGraphResult(poses_r=gf.poses_r, poses_t=gf.poses_t,
                           cost=cf, initial_cost=c0)


@f32_matmuls
@partial(jax.jit, static_argnames=("cfg",))
def optimize(g: PoseGraph, cfg: PoseGraphConfig = PoseGraphConfig()) -> PoseGraphResult:
    """Single-device pose-graph optimisation (jitted LM loop)."""
    return lm_loop(g, cfg)
