"""Sim(3) pose-graph optimisation — monocular scale-drift correction.

New surface relative to the reference (SURVEY.md §0): a monocular
trajectory's scale drifts along the chain (every pair's translation scale
is estimated from triangulated-depth ratios), so loop closures measure a
relative SCALE as well as a rigid transform, and an SE(3) pose graph
physically cannot absorb the inconsistency (see tests/test_sim3.py for
the constructed failure).  The standard fix — ORB-SLAM's 7-dof
optimisation (Strasdat et al., "Scale Drift-Aware Large Scale Monocular
SLAM") — optimises per-node similarities S_i = (s_i, R_i, t_i) acting
X -> s R X + t (world-to-camera).

Residual per edge (i, j) with measured similarity S_m ~ S_i ∘ S_j^-1:

    r_e = [t_err, log_SO3(R_err), log(s_err)]   of  S_m^-1 ∘ S_i ∘ S_j^-1

a 7-vector chart that vanishes iff the error is identity; Gauss-Newton
needs a chart, not the canonical Sim(3) log, so the translation block
skips the W-matrix coupling (same Jacobian structure at convergence).

Design mirrors `optim/posegraph.py`: matrix-free J/J^T via jvp/vjp of
the whole residual map, CG on the normal equations, `lax.scan` LM loop,
and an `axis_name` hook so the trajectory-partitioned distributed form
(SURVEY.md §2.4 D5) is the same code under shard_map.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from cusift_tpu.utils.precision import f32_matmuls

from . import robust

from ..config import PoseGraphConfig
from .lie import so3_exp, so3_log


class Sim3Graph(NamedTuple):
    """Static-capacity Sim(3) graph; edge weight 0 disables an edge."""

    poses_r: jnp.ndarray   # [N, 3, 3] world-to-camera rotation
    poses_t: jnp.ndarray   # [N, 3]
    poses_s: jnp.ndarray   # [N] positive scale (1 = metric anchor)
    edge_i: jnp.ndarray    # [E] int32
    edge_j: jnp.ndarray    # [E] int32
    meas_r: jnp.ndarray    # [E, 3, 3] measured S_i ∘ S_j^-1
    meas_t: jnp.ndarray    # [E, 3]
    meas_s: jnp.ndarray    # [E] measured relative scale (1 for odometry)
    weight: jnp.ndarray    # [E] sqrt-information scalar


class Sim3Result(NamedTuple):
    poses_r: jnp.ndarray
    poses_t: jnp.ndarray
    poses_s: jnp.ndarray
    cost: jnp.ndarray
    initial_cost: jnp.ndarray


def sim3_compose(sa, ra, ta, sb, rb, tb):
    """(sa,Ra,ta) ∘ (sb,Rb,tb): apply b first.  X -> sa Ra (sb Rb X + tb) + ta."""
    return (sa * sb, ra @ rb,
            sa[..., None] * (ra @ tb[..., None])[..., 0] + ta)


def sim3_inverse(s, r, t):
    rt = jnp.swapaxes(r, -1, -2)
    si = 1.0 / s
    return si, rt, -si[..., None] * (rt @ t[..., None])[..., 0]


def _residuals(xi: jnp.ndarray, g: Sim3Graph) -> jnp.ndarray:
    """[E, 7] weighted residuals at retraction xi [N, 7] about g's poses.

    Retraction (left-multiplicative): (e^sigma, exp(phi), rho) ∘ S_i with
    xi = [rho(3), phi(3), sigma(1)].
    """
    rho, phi, sig = xi[..., :3], xi[..., 3:6], xi[..., 6]
    ds = jnp.exp(sig)
    dr = so3_exp(phi)
    s, r, t = sim3_compose(ds, dr, rho, g.poses_s, g.poses_r, g.poses_t)

    si, ri, ti = s[g.edge_i], r[g.edge_i], t[g.edge_i]
    sj, rj, tj = s[g.edge_j], r[g.edge_j], t[g.edge_j]
    sji, rji, tji = sim3_inverse(sj, rj, tj)
    srel, rrel, trel = sim3_compose(si, ri, ti, sji, rji, tji)
    smi, rmi, tmi = sim3_inverse(g.meas_s, g.meas_r, g.meas_t)
    serr, rerr, terr = sim3_compose(smi, rmi, tmi, srel, rrel, trel)
    # per-edge translation normalisation: monocular chains drift their
    # unit MULTIPLICATIVELY, so edges measured at different chain epochs
    # carry |t| differing by orders of magnitude; in absolute units the
    # large-|t| edges' quadratic terms drown every rotation/log-scale
    # residual and LM stalls.  Dividing by |t_meas| makes the translation
    # block a relative error, commensurate with the (dimensionless)
    # rotation and log-scale blocks.  Near-zero measurements floor at 5%
    # of the graph's mean |t| so identity-like loop edges stay finite.
    tmag = jnp.linalg.norm(g.meas_t, axis=-1)
    active = (g.weight > 0).astype(jnp.float32)
    mean_t = (jnp.sum(tmag * active)
              / jnp.maximum(jnp.sum(active), 1.0))
    tnorm = jnp.maximum(tmag, 0.05 * mean_t + 1e-9)[..., None]
    res = jnp.concatenate(
        [terr / tnorm, so3_log(rerr),
         jnp.log(jnp.maximum(serr, 1e-12))[..., None]], -1)
    return res * g.weight[..., None]


@f32_matmuls
def cost(g: Sim3Graph, axis_name=None) -> jnp.ndarray:
    r = _residuals(jnp.zeros((g.poses_r.shape[0], 7)), g)
    c = 0.5 * jnp.sum(r ** 2)
    return jax.lax.psum(c, axis_name) if axis_name is not None else c


def _edge_norms(g: Sim3Graph) -> jnp.ndarray:
    """UNWEIGHTED per-edge residual norms at the current poses.

    The stored residuals carry the sqrt-information weight; dividing it
    out keeps the robust kernel's scale in residual units, so a weight-2
    loop edge (confidence) is not pushed toward the outlier regime at
    half the residual of an odometry edge.
    """
    r = _residuals(jnp.zeros((g.poses_r.shape[0], 7)), g)
    return jnp.linalg.norm(r, axis=-1) / jnp.maximum(g.weight, 1e-12)


def _robust_cost(g: Sim3Graph, delta: float, kernel: str,
                 axis_name=None) -> jnp.ndarray:
    """Robust cost on per-edge residual norms (delta <= 0: plain L2)."""
    if delta <= 0:
        return cost(g, axis_name)
    # information-weighted robust cost: sum_e w_e^2 rho(||r_e||_unweighted)
    # (reduces exactly to cost() when delta <= 0)
    c = jnp.sum(g.weight ** 2 * robust.rho(_edge_norms(g), delta, kernel))
    return jax.lax.psum(c, axis_name) if axis_name is not None else c


def _cg(matvec, b, iters: int):
    x = jnp.zeros_like(b)
    r = b
    p = r
    rs = jnp.sum(r * r)

    def body(carry, _):
        x, r, p, rs = carry
        ap = matvec(p)
        denom = jnp.sum(p * ap)
        alpha = jnp.where(jnp.abs(denom) > 1e-30, rs / denom, 0.0)
        x2 = x + alpha * p
        r2 = r - alpha * ap
        rs2 = jnp.sum(r2 * r2)
        beta = jnp.where(rs > 1e-30, rs2 / rs, 0.0)
        return (x2, r2, r2 + beta * p, rs2), None

    (x, _, _, _), _ = jax.lax.scan(body, (x, r, p, rs), None, length=iters)
    return x


@f32_matmuls
def lm_loop(g: Sim3Graph, cfg: PoseGraphConfig,
            axis_name=None) -> Sim3Result:
    """LM on the Sim(3) graph; node 0's 7 dof (incl. scale) fix the gauge.

    With `axis_name`, edges are the local shard and poses are replicated —
    the [N, 7] J^T r / J^T J x vectors each ride one psum, the replicated
    CG is identical on every device (SURVEY.md §2.4 D5 applied to Sim3).
    """
    n = g.poses_r.shape[0]
    mask = jnp.ones((n, 7))
    if cfg.fix_first_pose:
        mask = mask.at[0].set(0.0)

    def psum_(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x

    def apply_xi(g, xi):
        rho, phi, sig = xi[..., :3], xi[..., 3:6], xi[..., 6]
        s, r, t = sim3_compose(jnp.exp(sig), so3_exp(phi), rho,
                               g.poses_s, g.poses_r, g.poses_t)
        return g._replace(poses_r=r, poses_t=t, poses_s=s)

    delta = cfg.huber_delta

    def body(carry, _):
        g, lam, cur = carry
        zero = jnp.zeros((n, 7))
        if delta > 0:
            # IRLS: linearise the reweighted problem at the current poses
            # (sqrt-Huber weights), but evaluate acceptance on the true
            # robust cost so the loop optimises one consistent objective
            w_rob = robust.sqrt_weight(_edge_norms(g), delta,
                                       cfg.robust_kernel)
            g_it = g._replace(weight=g.weight * w_rob)
        else:
            g_it = g
        res0, vjp_fn = jax.vjp(lambda xi: _residuals(xi, g_it), zero)

        def normal_mv(x):
            x = x * mask
            _, jx = jax.jvp(lambda xi: _residuals(xi, g_it), (zero,), (x,))
            jtjx = psum_(vjp_fn(jx)[0])
            return (jtjx + lam * x) * mask

        b = -psum_(vjp_fn(res0)[0]) * mask
        dx = _cg(normal_mv, b, cfg.cg_iters) * mask
        cand = apply_xi(g, dx)
        cnew = _robust_cost(cand, delta, cfg.robust_kernel,
                             axis_name)
        accept = jnp.isfinite(cnew) & (cnew < cur)
        g2 = jax.tree.map(lambda a, b: jnp.where(accept, b, a), g, cand)
        lam2 = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e6)
        return (g2, lam2, jnp.where(accept, cnew, cur)), None

    c0 = _robust_cost(g, delta, cfg.robust_kernel, axis_name)
    init = (g, jnp.asarray(cfg.init_damping, jnp.float32), c0)
    (gf, _, cf), _ = jax.lax.scan(body, init, None, length=cfg.max_iters)
    return Sim3Result(poses_r=gf.poses_r, poses_t=gf.poses_t,
                      poses_s=gf.poses_s, cost=cf, initial_cost=c0)


@f32_matmuls
@partial(jax.jit, static_argnames=("cfg",))
def optimize(g: Sim3Graph,
             cfg: PoseGraphConfig = PoseGraphConfig()) -> Sim3Result:
    """Single-device Sim(3) pose-graph optimisation (jitted LM loop)."""
    return lm_loop(g, cfg)
