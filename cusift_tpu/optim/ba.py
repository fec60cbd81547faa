"""Bundle adjustment: Levenberg–Marquardt with matrix-free Schur + PCG.

New surface relative to the reference (SURVEY.md §0, BASELINE north star):
cuSIFT stops at pairwise transforms; this engine adds full BA.

Design (SURVEY.md §2.4 D4): the sparse normal equations are never formed.
Per-observation Jacobian blocks (J_c [2,6], J_p [2,3]) come from `jacfwd`
over a retraction at zero; camera blocks U, landmark blocks V, and the
coupling W stay as segment-sums / per-observation arrays; the reduced camera
system S = U - W V^-1 W^T is applied *implicitly* inside PCG:

    (S x)_c = (U_c + D) x_c - sum_{o: c(o)=c} W_o V_{p(o)}^-1 t_{p(o)},
    t_p     = sum_{o in p} W_o^T x_{c(o)}

— all gathers + segment-sums, which (a) XLA fuses into dense batched ops
and (b) distribute over a mesh by sharding observations/landmarks with one
`psum` of camera-sized quantities across devices (see parallel/dist_ba.py).
Landmark back-substitution is a batched 3x3 solve.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from cusift_tpu.utils.precision import f32_matmuls

from ..config import BAConfig
from ..ops.geometry import project
from ..ops.mat3 import inv3_spd
from .lie import se3_exp, transform

_seg = jax.ops.segment_sum


class BAProblem(NamedTuple):
    """Static-shape BA problem; w == 0 disables an observation."""

    poses_r: jnp.ndarray   # [C, 3, 3] world-to-camera rotations
    poses_t: jnp.ndarray   # [C, 3]
    points: jnp.ndarray    # [L, 3] world landmarks
    intr: jnp.ndarray      # [4] fx, fy, cx, cy
    cam_idx: jnp.ndarray   # [O] int32
    pt_idx: jnp.ndarray    # [O] int32
    uv: jnp.ndarray        # [O, 2] pixel measurements
    w: jnp.ndarray         # [O] observation weights (0 = invalid)


class BAResult(NamedTuple):
    poses_r: jnp.ndarray
    poses_t: jnp.ndarray
    points: jnp.ndarray
    cost: jnp.ndarray          # final weighted cost
    initial_cost: jnp.ndarray
    iterations: jnp.ndarray


def _residual_fn(eps_c, eps_p, r, t, x, uv, intr):
    """Reprojection residual after retracting pose and point by (eps_c, eps_p)."""
    dr, dt = se3_exp(eps_c)
    rc = dr @ r
    tc = (dr @ t[..., None])[..., 0] + dt
    pc = transform(rc, tc, x + eps_p)
    return project(pc[None, :], intr[0], intr[1], intr[2], intr[3])[0] - uv


def _residuals_and_jacobians(p: BAProblem):
    """Per-observation residual [O,2], J_c [O,2,6], J_p [O,2,3]."""
    r = p.poses_r[p.cam_idx]
    t = p.poses_t[p.cam_idx]
    x = p.points[p.pt_idx]
    z6 = jnp.zeros(6)
    z3 = jnp.zeros(3)

    def one(r, t, x, uv):
        res = _residual_fn(z6, z3, r, t, x, uv, p.intr)
        jc, jp = jax.jacfwd(_residual_fn, argnums=(0, 1))(z6, z3, r, t, x, uv, p.intr)
        return res, jc, jp

    return jax.vmap(one)(r, t, x, p.uv)


def _robust_weights(res: jnp.ndarray, w: jnp.ndarray, delta: float):
    """Huber IRLS weights on top of the observation weights."""
    if delta <= 0:
        return w
    nrm = jnp.linalg.norm(res, axis=-1)
    return w * jnp.minimum(1.0, delta / jnp.maximum(nrm, 1e-12))


@f32_matmuls
def cost(p: BAProblem, huber_delta: float = 0.0, axis_name=None) -> jnp.ndarray:
    res, _, _ = _residuals_and_jacobians(p)
    res = jnp.where((p.w > 0)[:, None], res, 0.0)   # see _mask_dead_obs
    sq = jnp.sum(res ** 2, -1)
    if huber_delta > 0:
        nrm = jnp.sqrt(jnp.maximum(sq, 1e-18))
        rho = jnp.where(nrm <= huber_delta, sq,
                        2 * huber_delta * nrm - huber_delta ** 2)
    else:
        rho = sq
    c = 0.5 * jnp.sum(p.w * rho)
    return jax.lax.psum(c, axis_name) if axis_name is not None else c


def _mask_dead_obs(w, res, jc, jp):
    """Zero residuals/Jacobians of weight-0 observations BEFORE products.

    A dead slot (weight 0) can sit at z ~ 1e-9 after the projection
    clamp: its Jacobian entries reach ~1e20, so J^T J overflows f32 to
    inf before the zero weight multiplies — and 0 * inf = NaN poisons
    the whole window's normal equations, silently disabling BA for that
    window (every LM step rejects on a non-finite cost).
    """
    live = (w > 0)[:, None]
    return (jnp.where(live, res, 0.0),
            jnp.where(live[..., None], jc, 0.0),
            jnp.where(live[..., None], jp, 0.0))


class _Blocks(NamedTuple):
    u: jnp.ndarray      # [C, 6, 6]
    v_inv: jnp.ndarray  # [L, 3, 3]
    wo: jnp.ndarray     # [O, 6, 3]
    b_c: jnp.ndarray    # [C, 6]
    b_p: jnp.ndarray    # [L, 3]


@f32_matmuls
def build_blocks(p: BAProblem, damping, huber_delta: float,
                 res=None, jc=None, jp=None, axis_name=None) -> _Blocks:
    """Gauss-Newton blocks with LM damping folded into U and V.

    Under shard_map the U blocks are later psum'd over `axis_name`, so the
    per-shard damping contribution is divided by the shard count — the
    reduced camera system then carries exactly (damping + eps) * I
    regardless of device count, keeping single-device and distributed LM
    steps identical.
    """
    if res is None:
        res, jc, jp = _residuals_and_jacobians(p)
    res, jc, jp = _mask_dead_obs(p.w, res, jc, jp)
    c, l = p.poses_r.shape[0], p.points.shape[0]
    w = _robust_weights(res, p.w, huber_delta)[:, None, None]  # [O,1,1]

    jct = jnp.swapaxes(jc, -1, -2)                    # [O, 6, 2]
    jpt = jnp.swapaxes(jp, -1, -2)                    # [O, 3, 2]
    u = _seg(w * (jct @ jc), p.cam_idx, num_segments=c)       # [C,6,6]
    v = _seg(w * (jpt @ jp), p.pt_idx, num_segments=l)        # [L,3,3]
    wo = w * (jct @ jp)                                        # [O,6,3]
    b_c = -_seg((w * jct @ res[..., None])[..., 0], p.cam_idx, num_segments=c)
    b_p = -_seg((w * jpt @ res[..., None])[..., 0], p.pt_idx, num_segments=l)

    # LM damping; the small epsilon keeps unobserved blocks invertible.
    n_shards = (jax.lax.psum(1, axis_name) if axis_name is not None else 1)
    u = u + (damping + 1e-8) / n_shards * jnp.eye(6)[None]
    v = v + (damping + 1e-8) * jnp.eye(3)[None]
    # inv3_spd, NOT the cofactor inv3: a thin-ray landmark block has
    # condition ~1e8+, where the f32 cofactor inverse is catastrophically
    # wrong (measured: true ||V^-1|| ~3e3, inv3 ~5e21 — the garbage rides
    # the Schur reduction into every camera block and breaks the window
    # solve for BOTH the CG and dense paths).  The clamped-Cholesky form
    # bounds the inverse and turns f32 cancellation into benign extra
    # damping of the unobservable direction (ops/mat3.py).
    v_inv = inv3_spd(v)
    return _Blocks(u=u, v_inv=v_inv, wo=wo, b_c=b_c, b_p=b_p)


@f32_matmuls
def schur_matvec(blocks: _Blocks, cam_idx, pt_idx, x, cam_mask, axis_name=None):
    """(S x) for camera-delta x [C, 6]; cam_mask [C] fixes gauge poses.

    With `axis_name` set, camera-sized partial sums are psum-reduced so the
    same code runs inside shard_map over observation/landmark shards
    (SURVEY.md §2.4 D4).  Sharding invariant: every landmark's observations
    are colocated on one shard, so t_p and the V blocks stay shard-local —
    only [C, 6]-sized camera quantities ride the interconnect.
    """
    x = x * cam_mask[:, None]
    t_p = _seg((jnp.swapaxes(blocks.wo, -1, -2) @ x[cam_idx][..., None])[..., 0],
               pt_idx, num_segments=blocks.v_inv.shape[0])       # [L, 3] local
    y = (blocks.v_inv @ t_p[..., None])[..., 0]                  # [L, 3]
    corr = _seg((blocks.wo @ y[pt_idx][..., None])[..., 0],
                cam_idx, num_segments=x.shape[0])                # [C, 6]
    if axis_name is not None:
        corr = jax.lax.psum(corr, axis_name)
    sx = (blocks.u @ x[..., None])[..., 0] - corr
    return sx * cam_mask[:, None]


@f32_matmuls
def reduced_rhs(blocks: _Blocks, cam_idx, pt_idx, cam_mask, axis_name=None):
    """b~_c = b_c - W V^-1 b_p (the Schur-reduced right-hand side)."""
    y = (blocks.v_inv @ blocks.b_p[..., None])[..., 0]           # [L, 3]
    corr = _seg((blocks.wo @ y[pt_idx][..., None])[..., 0],
                cam_idx, num_segments=blocks.b_c.shape[0])
    if axis_name is not None:
        corr = jax.lax.psum(corr, axis_name)
    return (blocks.b_c - corr) * cam_mask[:, None]


def pcg(matvec, b, precond, iters: int, tol: float):
    """Preconditioned conjugate gradients on the camera system."""
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    p0 = z0
    rz0 = jnp.sum(r0 * z0)
    bnorm = jnp.maximum(jnp.sqrt(jnp.sum(b * b)), 1e-30)

    def body(carry, _):
        x, r, p, rz, done = carry
        ap = matvec(p)
        denom = jnp.sum(p * ap)
        alpha = jnp.where(jnp.abs(denom) > 1e-30, rz / denom, 0.0)
        # freeze once converged (scan has no early exit; a zero step keeps
        # x/r/p fixed for the remaining iterations)
        alpha = jnp.where(done, 0.0, alpha)
        x2 = x + alpha * p
        r2 = r - alpha * ap
        z2 = precond(r2)
        rz2 = jnp.sum(r2 * z2)
        beta = jnp.where(jnp.abs(rz) > 1e-30, rz2 / rz, 0.0)
        p2 = jnp.where(done, p, z2 + beta * p)
        rz2 = jnp.where(done, rz, rz2)
        done = done | (jnp.sqrt(jnp.sum(r2 * r2)) / bnorm < tol)
        return (x2, r2, p2, rz2, done), None

    init = (x0, r0, p0, rz0, jnp.asarray(False))
    (x, _, _, _, _), _ = jax.lax.scan(body, init, None, length=iters)
    return x


@f32_matmuls
def _dense_schur_solve(p: BAProblem, blocks: _Blocks, b, cam_mask,
                       res, jc, huber_delta: float, damping):
    """Explicit [6C, 6C] Schur complement + Cholesky (BAConfig.solver).

    At window scale (C=5 -> 30 dofs) this replaces cg_iters sequential
    matvec rounds — pure program latency on the device — with batched
    einsums over the landmark blocks and one tiny factorisation (the
    same trade as the dense pose-graph solver).

    f32 numerics (both measured necessary at LM damping 1e-3, where the
    naive assembly read window-BA ATE 0.27 vs the CG path's 0.20):
      * the sum S = blockdiag(U) - sum_p A_p V_p^-1 A_p^T is assembled
        as sum_p (U_p - A_p V_p^-1 A_p^T): each per-landmark term is
        itself a (PSD) Schur complement, so the big cancellation between
        the two grouped sums never materialises;
      * Jacobi equilibration D^-1/2 S D^-1/2 before the Cholesky —
        rotational and translational dofs differ by orders of magnitude
        in curvature.
    Gauge-fixed camera dofs get zeroed rows/cols and a unit diagonal.
    """
    c = p.poses_r.shape[0]
    l = blocks.v_inv.shape[0]
    key = p.pt_idx * c + p.cam_idx
    a = _seg(blocks.wo, key, num_segments=l * c).reshape(l, c * 6, 3)
    w = _robust_weights(res, p.w, huber_delta)[:, None, None]
    jct = jnp.swapaxes(jc, -1, -2)
    u_obs = w * (jct @ jc)                                # [O, 6, 6]
    ulc = _seg(u_obs, key, num_segments=l * c).reshape(l, c, 6, 6)
    # per-landmark block-diagonal embed [L, 6C, 6C] via the camera eye
    bd = (jnp.eye(c)[None, :, None, :, None]
          * ulc[:, :, :, None, :]).reshape(l, 6 * c, 6 * c)
    av = jax.lax.batch_matmul(a, blocks.v_inv)            # [L, 6C, 3]
    s_l = bd - jax.lax.batch_matmul(av, jnp.swapaxes(a, -1, -2))
    sm = jnp.sum(s_l, axis=0) + (damping + 1e-8) * jnp.eye(6 * c)
    m = jnp.repeat(cam_mask, 6)
    sm = sm * m[:, None] * m[None, :] + jnp.diag(1.0 - m)
    # U-whitened eigen-truncated solve, NOT Cholesky/LU: the window
    # system's condition reaches 1e8+ (near-unobservable camera dof
    # combinations), where (a) f32 assembly error leaves the matrix
    # numerically indefinite — Cholesky NaNs and LM silently rejects
    # every step — and (b) an exact solve steps hugely along the
    # near-null directions, distorting geometry for a marginal cost
    # decrease (measured ATE regressions for both).  Whitening by the
    # block-diagonal camera curvature U (the same preconditioner the CG
    # path uses) maps the spectrum into [0, 1] — S = U - PSD implies
    # T = Lu^-1 S Lu^-T <= I — and eigencomponents near 0 are exactly
    # the directions the landmark reduction made unobservable: zeroing
    # them moves only where the window has information, the implicit
    # regularisation that makes the truncated-CG path behave.
    um = jax.scipy.linalg.block_diag(*blocks.u)
    um = um * m[:, None] * m[None, :] + jnp.diag(1.0 - m)
    du = jnp.sqrt(jnp.maximum(jnp.diagonal(um), 1e-30))
    um = um / du[:, None] / du[None, :]     # Jacobi-equilibrated U
    um = um + 1e-6 * jnp.eye(6 * c)
    lu = jnp.linalg.cholesky(um)
    smw = sm / du[:, None] / du[None, :]
    t1 = jax.scipy.linalg.solve_triangular(lu, smw, lower=True)
    t = jax.scipy.linalg.solve_triangular(lu, t1.T, lower=True)
    lam, vec = jnp.linalg.eigh(t)
    keep = lam > 1e-3
    inv_l = jnp.where(keep, 1.0 / jnp.where(keep, lam, 1.0), 0.0)
    bw = jax.scipy.linalg.solve_triangular(lu, b.reshape(-1) * m / du,
                                           lower=True)
    dcw = vec @ (inv_l * (vec.T @ bw))
    dc = jax.scipy.linalg.solve_triangular(lu.T, dcw, lower=False) / du
    return dc.reshape(c, 6) * cam_mask[:, None]


@f32_matmuls
def solve_normal_equations(p: BAProblem, damping, cfg: BAConfig, axis_name=None):
    """One damped GN step: returns (delta_c [C,6], delta_p [L,3]).

    Under shard_map (axis_name set), p's observations/landmarks are the
    local shard; U and b_c partial sums are all-reduced so every shard
    solves the identical replicated camera system, then back-substitutes
    its local landmarks.
    """
    c = p.poses_r.shape[0]
    res, jc, jp = _mask_dead_obs(p.w, *_residuals_and_jacobians(p))
    blocks = build_blocks(p, damping, cfg.huber_delta, res=res, jc=jc,
                          jp=jp, axis_name=axis_name)
    if axis_name is not None:
        blocks = blocks._replace(u=jax.lax.psum(blocks.u, axis_name),
                                 b_c=jax.lax.psum(blocks.b_c, axis_name))
    cam_mask = jnp.ones((c,))
    nfix = max(cfg.num_fixed_poses, 1 if cfg.fix_first_pose else 0)
    if nfix > 0:
        cam_mask = cam_mask.at[:nfix].set(0.0)

    u_inv = jnp.linalg.inv(blocks.u)

    def precond(r):
        return (u_inv @ r[..., None])[..., 0] * cam_mask[:, None]

    b = reduced_rhs(blocks, p.cam_idx, p.pt_idx, cam_mask, axis_name)
    if cfg.solver == "dense" and axis_name is None:
        dc = _dense_schur_solve(p, blocks, b, cam_mask, res, jc,
                                cfg.huber_delta, damping)
    else:
        mv = lambda x: schur_matvec(blocks, p.cam_idx, p.pt_idx, x,
                                    cam_mask, axis_name)
        dc = pcg(mv, b, precond, cfg.cg_iters, cfg.cg_tol)

    # back-substitute landmarks: dp = V^-1 (b_p - W^T dc)
    t_p = _seg((jnp.swapaxes(blocks.wo, -1, -2) @ (dc * cam_mask[:, None])[p.cam_idx][..., None])[..., 0],
               p.pt_idx, num_segments=p.points.shape[0])
    dp = (blocks.v_inv @ (blocks.b_p - t_p)[..., None])[..., 0]
    return dc, dp


@f32_matmuls
def apply_step(p: BAProblem, dc, dp) -> BAProblem:
    dr, dt = se3_exp(dc)                                  # [C,3,3],[C,3]
    r2 = dr @ p.poses_r
    t2 = (dr @ p.poses_t[..., None])[..., 0] + dt
    return p._replace(poses_r=r2, poses_t=t2, points=p.points + dp)


@f32_matmuls
def lm_loop(p: BAProblem, cfg: BAConfig, axis_name=None) -> BAResult:
    """Full LM loop (static iteration count, accept/reject inside).

    Runs standalone (axis_name=None) or inside shard_map with sharded
    observations + landmarks and replicated poses (parallel/dist_ba.py).
    """
    c0 = cost(p, cfg.huber_delta, axis_name)

    def body(carry, _):
        prob, lam, cur, its = carry
        dc, dp = solve_normal_equations(prob, lam, cfg, axis_name)
        cand = apply_step(prob, dc, dp)
        cnew = cost(cand, cfg.huber_delta, axis_name)
        finite = jnp.isfinite(cnew)
        accept = finite & (cnew < cur)
        prob2 = jax.tree.map(lambda a, b: jnp.where(accept, b, a), prob, cand)
        lam2 = jnp.where(accept, lam * cfg.damping_down, lam * cfg.damping_up)
        lam2 = jnp.clip(lam2, 1e-10, 1e6)
        cur2 = jnp.where(accept, cnew, cur)
        return (prob2, lam2, cur2, its + accept.astype(jnp.int32)), None

    init = (p, jnp.asarray(cfg.init_damping, jnp.float32), c0, jnp.asarray(0))
    (pf, _, cf, its), _ = jax.lax.scan(body, init, None, length=cfg.max_iters)
    return BAResult(poses_r=pf.poses_r, poses_t=pf.poses_t, points=pf.points,
                    cost=cf, initial_cost=c0, iterations=its)


@f32_matmuls
@partial(jax.jit, static_argnames=("cfg",))
def bundle_adjust(p: BAProblem, cfg: BAConfig = BAConfig()) -> BAResult:
    """Single-device bundle adjustment (jitted LM loop)."""
    return lm_loop(p, cfg)
