"""Distributed bundle adjustment via sharded Schur reduction (D4).

The hard distribution problem (SURVEY.md §2.4): landmarks + their
observations are sharded over the mesh's "map" axis (observation-to-shard
assignment keeps every landmark's observations colocated, so the landmark
blocks V and the per-landmark reduction t_p stay shard-local).  Camera poses
are replicated; the reduced camera system is all-reduced with `psum` across
devices and solved identically on every shard; landmark back-substitution is
local.  The inner solver is literally `optim.ba.lm_loop` with an axis name —
the single-device and distributed paths share every line of math.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from cusift_tpu.utils.precision import f32_matmuls
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import BAConfig
from ..optim.ba import BAProblem, BAResult, lm_loop


def partition_by_landmark(problem: dict, n_shards: int) -> dict:
    """Host-side partitioning of a BA problem into landmark-colocated shards.

    Landmarks are dealt round-robin by index; observations follow their
    landmark.  Shards are padded to equal static sizes (weight 0 padding).
    Returns arrays with a leading [n_shards] axis and shard-local pt_idx.
    """
    pt_idx = np.asarray(problem["pt_idx"])
    n_pts = problem["points"].shape[0]
    shard_of_pt = np.arange(n_pts) % n_shards
    local_pt = np.arange(n_pts) // n_shards          # shard-local landmark id
    l_shard = int(np.ceil(n_pts / n_shards))
    o_shard = 0
    obs_by_shard = []
    for s in range(n_shards):
        sel = np.nonzero(shard_of_pt[pt_idx] == s)[0]
        obs_by_shard.append(sel)
        o_shard = max(o_shard, len(sel))

    def pad_obs(arr, sel, fill=0):
        out = np.full((o_shard,) + arr.shape[1:], fill, arr.dtype)
        out[: len(sel)] = arr[sel]
        return out

    points = np.zeros((n_shards, l_shard, 3), np.float32)
    for p in range(n_pts):
        points[shard_of_pt[p], local_pt[p]] = problem["points"][p]

    out = dict(
        poses_r=problem["poses_r"], poses_t=problem["poses_t"],
        intr=problem["intr"], points=points,
        cam_idx=np.stack([pad_obs(problem["cam_idx"], s) for s in obs_by_shard]),
        pt_idx=np.stack([pad_obs(local_pt[pt_idx].astype(np.int32), s)
                         for s in obs_by_shard]),
        uv=np.stack([pad_obs(problem["uv"], s) for s in obs_by_shard]),
        w=np.stack([pad_obs(problem["w"], s) for s in obs_by_shard]),
        # bookkeeping to scatter results back: global id per local slot
        global_pt=np.stack([
            np.concatenate([np.nonzero(shard_of_pt == s)[0],
                            np.full(l_shard - (shard_of_pt == s).sum(), -1)])
            for s in range(n_shards)]).astype(np.int32),
    )
    return out


@f32_matmuls
def distributed_bundle_adjust(parts: dict, mesh: Mesh,
                              cfg: BAConfig = BAConfig()) -> BAResult:
    """Run LM bundle adjustment over landmark shards on the "map" axis.

    `parts` comes from `partition_by_landmark` (leading [n_shards] axis on
    observation/landmark arrays; poses replicated).  Returns a BAResult
    whose points keep the [n_shards, L_shard, 3] layout (use `gather_points`
    to reassemble the global array).
    """
    sharded = P("map")
    repl = P()

    @partial(jax.jit, static_argnames=())
    @partial(shard_map, mesh=mesh,
             in_specs=(repl, repl, sharded, repl, sharded, sharded,
                       sharded, sharded),
             out_specs=BAResult(poses_r=repl, poses_t=repl, points=sharded,
                                cost=repl, initial_cost=repl,
                                iterations=repl),
             check_vma=False)
    def run(poses_r, poses_t, points, intr, cam_idx, pt_idx, uv, w):
        p = BAProblem(poses_r=poses_r, poses_t=poses_t, points=points[0],
                      intr=intr, cam_idx=cam_idx[0], pt_idx=pt_idx[0],
                      uv=uv[0], w=w[0])
        res = lm_loop(p, cfg, axis_name="map")
        return res._replace(points=res.points[None])

    return run(jnp.asarray(parts["poses_r"]), jnp.asarray(parts["poses_t"]),
               jnp.asarray(parts["points"]), jnp.asarray(parts["intr"]),
               jnp.asarray(parts["cam_idx"]), jnp.asarray(parts["pt_idx"]),
               jnp.asarray(parts["uv"]), jnp.asarray(parts["w"]))


from functools import lru_cache


@lru_cache(maxsize=8)
def _window_ba_dist_fn(mesh: Mesh, match_cfg, ba_cfg: BAConfig,
                       gate_px: float, n_shards: int):
    """One cached jitted program per (mesh, configs): the streaming loop
    calls this every keyframe insert, and rebuilding the shard_map
    closure per call would retrace each time (measured ~6.5 s/call on
    the virtual mesh — the scaling-table run caught it)."""

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(), P("map"), P(), P("map"), P("map"),
                       P("map"), P("map")),
             out_specs=(P(), P(), P(), P()), check_vma=False)
    def run(poses_r, poses_t, points, intr, cam_idx, pt_idx, wt, uv):
        p = BAProblem(poses_r=poses_r, poses_t=poses_t, points=points[0],
                      intr=intr, cam_idx=cam_idx[0], pt_idx=pt_idx[0],
                      uv=uv[0], w=wt[0])
        res = lm_loop(p, ba_cfg, axis_name="map")
        return res.poses_r, res.poses_t, res.initial_cost, res.cost

    @jax.jit
    def fn(kf_desc, kf_valid, kf_pts, poses_r, poses_t, intr, win_mask):
        from ..models.local_ba import build_window_problem

        w, n = kf_valid.shape
        l_shard = n // n_shards
        prob = build_window_problem(kf_desc, kf_valid, kf_pts, poses_r,
                                    poses_t, intr, win_mask, match_cfg,
                                    gate_px)

        # static landmark-block sharding: [W*N] obs grid -> [S, W*L]
        def to_shards(a):
            a = a.reshape((w, n_shards, l_shard) + a.shape[2:])
            return jnp.moveaxis(a, 1, 0).reshape(
                (n_shards, w * l_shard) + a.shape[3:])

        uv = to_shards(prob.uv.reshape(w, n, 2))
        wt = to_shards(prob.w.reshape(w, n))
        points = prob.points.reshape(n_shards, l_shard, 3)
        cam_idx = jnp.broadcast_to(
            jnp.repeat(jnp.arange(w, dtype=jnp.int32), l_shard),
            (n_shards, w * l_shard))
        pt_idx = jnp.broadcast_to(
            jnp.tile(jnp.arange(l_shard, dtype=jnp.int32), w),
            (n_shards, w * l_shard))
        r, t, c0, c1 = run(prob.poses_r, prob.poses_t, points, prob.intr,
                           cam_idx, pt_idx, wt, uv)
        keep = win_mask[:, None, None] > 0
        r_out = jnp.where(keep, r, poses_r)
        t_out = jnp.where(keep[..., 0], t, poses_t)
        return r_out, t_out, c0, c1

    return fn


@f32_matmuls
def window_ba_dist(kf_desc, kf_valid, kf_pts, poses_r, poses_t, intr,
                   win_mask, mesh: Mesh,
                   match_cfg=None, ba_cfg: BAConfig = None,
                   gate_px: float = 25.0):
    """Distributed sliding-window BA: the STREAMING production form of D4.

    `models/local_ba.py:window_ba` with the Schur solve sharded over the
    mesh's "map" axis.  Unlike `partition_by_landmark` (host-side, for
    arbitrary problems), the window problem's observation grid is [W, N]
    with landmark n owning column n — so landmark-colocated sharding is a
    pure STATIC reshape: shard s owns the landmark block [s L, (s+1) L),
    its observations are the matching [W, L] sub-grid, and no host
    round-trip or dynamic partitioning exists anywhere.  Association runs
    replicated (one [N, N] match matmul per window keyframe — cheap next
    to the LM iterations); the per-landmark V-block reductions stay
    shard-local; the reduced camera system rides one psum per CG step
    (`optim/ba.py:lm_loop(axis_name)`).

    Drop-in signature for `window_ba` plus `mesh`; returns the same
    (poses_r, poses_t, initial_cost, final_cost).  The jitted program is
    cached per (mesh, configs), so streaming callers pay one compile.
    """
    from ..config import MatchConfig

    if match_cfg is None:
        match_cfg = MatchConfig()
    if ba_cfg is None:
        ba_cfg = BAConfig(max_iters=5, cg_iters=15, num_fixed_poses=2,
                          huber_delta=4.0)
    n_shards = mesh.shape["map"]
    n = kf_valid.shape[1]
    assert n % n_shards == 0, (n, n_shards)
    fn = _window_ba_dist_fn(mesh, match_cfg, ba_cfg, float(gate_px),
                            int(n_shards))
    return fn(kf_desc, kf_valid, kf_pts, poses_r, poses_t, intr, win_mask)


def gather_points(parts: dict, sharded_points) -> np.ndarray:
    """Reassemble [L, 3] global landmarks from sharded [S, L_s, 3] output."""
    gp = np.asarray(parts["global_pt"])
    pts = np.asarray(sharded_points)
    n_pts = int(gp.max()) + 1
    out = np.zeros((n_pts, 3), np.float32)
    for s in range(gp.shape[0]):
        valid = gp[s] >= 0
        out[gp[s][valid]] = pts[s][valid]
    return out
