"""Small-scale incremental SfM (BASELINE configs[2]).

New surface relative to the reference: cuSIFT's extract/match/rigid pieces
composed into multi-view structure-from-motion: pairwise matching builds
feature *tracks* (union-find over match edges, host-side graph logic),
poses are chained from RGB-D rigid alignments, landmarks initialise from
depth back-projection, and the whole problem is polished by the Schur
BA (optim/ba.py).  The BA problem is a static-shape BAProblem, so repeated
refinements reuse one compiled program.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (BAConfig, MatchConfig, RansacConfig, SiftConfig)
from ..optim.ba import BAProblem, BAResult, bundle_adjust
from ..ops.match import match
from ..ops.ransac import find_rigid
from .slam import _extract_with_points


class SfmReconstruction(NamedTuple):
    poses_r: np.ndarray    # [F, 3, 3] world-to-camera
    poses_t: np.ndarray    # [F, 3]
    points: np.ndarray     # [L, 3] world landmarks
    ba: BAResult
    n_tracks: int
    n_obs: int


class _UnionFind:
    def __init__(self, n):
        self.p = list(range(n))

    def find(self, x):
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[rb] = ra


def reconstruct_rgbd(images, depths, intr,
                     sift_cfg: SiftConfig = SiftConfig(),
                     match_cfg: MatchConfig = MatchConfig(),
                     ransac_cfg: RansacConfig = RansacConfig(),
                     ba_cfg: BAConfig = BAConfig(),
                     max_tracks: int = 4096, seed: int = 0) -> SfmReconstruction:
    """Incremental RGB-D SfM over a short sequence (10-frame TUM snippet).

    Pipeline: per-frame extract (jitted, one compile) -> consecutive-pair
    match + rigid RANSAC for initial poses -> track building (union-find)
    -> landmark init from the earliest observation's depth -> Schur BA.
    """
    f = len(images)
    intr_j = jnp.asarray(intr)
    key = jax.random.PRNGKey(seed)

    feats, pts3, pvalid = [], [], []
    for i in range(f):
        fe, pt, pv = _extract_with_points(jnp.asarray(images[i]),
                                          jnp.asarray(depths[i]), intr_j,
                                          sift_cfg)
        feats.append(fe)
        pts3.append(np.asarray(pt))
        pvalid.append(np.asarray(pv))

    n = sift_cfg.total_kpts
    uf = _UnionFind(f * n)
    slot = lambda fr, k: fr * n + k

    # chain poses from consecutive rigid alignments; collect match edges
    poses_r = [np.eye(3, dtype=np.float32)]
    poses_t = [np.zeros(3, np.float32)]
    pairs = [(i, i + 1) for i in range(f - 1)] + [(i, i + 2) for i in range(f - 2)]
    rel_cache = {}
    for (a, b) in pairs:
        key, k = jax.random.split(key)
        m = match(feats[a].desc, feats[a].valid, feats[b].desc,
                  feats[b].valid, match_cfg)
        idx = np.asarray(m.idx)
        ok = np.asarray(m.ok) & pvalid[a]
        pb = pts3[b][idx]
        ok = ok & (pb[:, 2] > 1e-6)
        rig = find_rigid(jnp.asarray(pts3[a]), jnp.asarray(pb),
                         jnp.asarray(ok), ransac_cfg, k)
        if not bool(rig.ok):
            continue
        inl = np.asarray(rig.inliers)
        rel_cache[(a, b)] = (np.asarray(rig.r), np.asarray(rig.t))
        for ka in np.nonzero(inl)[0]:
            uf.union(slot(a, int(ka)), slot(b, int(idx[ka])))

    for i in range(1, f):
        if (i - 1, i) in rel_cache:
            r_rel, t_rel = rel_cache[(i - 1, i)]
            # X_i = R X_{i-1} + t  =>  T_i<-w = (R, t) * T_{i-1}<-w
            ri = r_rel @ poses_r[i - 1]
            ti = r_rel @ poses_t[i - 1] + t_rel
        else:  # tracking gap: reuse previous pose
            ri, ti = poses_r[i - 1], poses_t[i - 1]
        poses_r.append(ri.astype(np.float32))
        poses_t.append(ti.astype(np.float32))
    poses_r = np.stack(poses_r)
    poses_t = np.stack(poses_t)

    # build tracks: root slot -> landmark id (only tracks seen >= 2 times)
    members: dict[int, list] = {}
    for fr in range(f):
        val = np.asarray(feats[fr].valid) & pvalid[fr]
        for k in np.nonzero(val)[0]:
            members.setdefault(uf.find(slot(fr, int(k))), []).append((fr, int(k)))
    tracks = [m for m in members.values()
              if len({fr for fr, _ in m}) >= 2][:max_tracks]

    # landmarks from the earliest observation's depth back-projection
    # (feature coordinates fetched once per frame — per-observation
    # np.asarray would pay a host round-trip each)
    xs_np = [np.asarray(fe.x) for fe in feats]
    ys_np = [np.asarray(fe.y) for fe in feats]
    cam_idx, pt_idx, uvs, ws = [], [], [], []
    points = []
    for li, obs in enumerate(tracks):
        obs = sorted(obs)
        fr0, k0 = obs[0]
        pc = pts3[fr0][k0]                       # camera-frame point
        r0, t0 = poses_r[fr0], poses_t[fr0]
        pw = r0.T @ (pc - t0)                    # to world
        points.append(pw)
        seen = set()
        for fr, k in obs:
            if fr in seen:                       # one observation per frame
                continue
            seen.add(fr)
            cam_idx.append(fr)
            pt_idx.append(li)
            uvs.append((xs_np[fr][k], ys_np[fr][k]))
            ws.append(1.0)

    n_obs = len(cam_idx)
    prob = BAProblem(
        poses_r=jnp.asarray(poses_r), poses_t=jnp.asarray(poses_t),
        points=jnp.asarray(np.array(points, np.float32)),
        intr=intr_j,
        cam_idx=jnp.asarray(np.array(cam_idx, np.int32)),
        pt_idx=jnp.asarray(np.array(pt_idx, np.int32)),
        uv=jnp.asarray(np.array(uvs, np.float32)),
        w=jnp.asarray(np.array(ws, np.float32)),
    )
    res = bundle_adjust(prob, ba_cfg)
    return SfmReconstruction(poses_r=np.asarray(res.poses_r),
                             poses_t=np.asarray(res.poses_t),
                             points=np.asarray(res.points),
                             ba=res, n_tracks=len(tracks), n_obs=n_obs)


def _triangulate_world(ra, ta, rb, tb, xa_n, xb_n):
    """Triangulate normalised correspondences between two REGISTERED
    world-to-camera poses -> (world points [N, 3], za, zb, cos_parallax).

    Relative pose: X_b = R_ab X_a + t_ab with R_ab = Rb Ra^T,
    t_ab = tb - R_ab ta; midpoint triangulation in the A camera frame,
    world points through X_w = Ra^T (X_a - ta).  cos_parallax is the
    angle between the two viewing rays (1.0 = no parallax).
    """
    from ..ops.essential import triangulate_midpoint

    r_ab = rb @ ra.T
    t_ab = tb - r_ab @ ta
    pts_a, za, zb = triangulate_midpoint(jnp.asarray(r_ab),
                                         jnp.asarray(t_ab),
                                         jnp.asarray(xa_n),
                                         jnp.asarray(xb_n))
    pts_a = np.asarray(pts_a)
    da = np.concatenate([xa_n, np.ones_like(xa_n[:, :1])], -1)
    db = np.concatenate([xb_n, np.ones_like(xb_n[:, :1])], -1) @ r_ab
    cosp = np.abs(np.sum(da * db, -1)) / np.maximum(
        np.linalg.norm(da, axis=-1) * np.linalg.norm(db, axis=-1), 1e-12)
    pw = (pts_a - ta) @ ra
    return pw, np.asarray(za), np.asarray(zb), cosp


def reconstruct_mono(images, intr,
                     sift_cfg: SiftConfig = SiftConfig(),
                     match_cfg: MatchConfig = MatchConfig(),
                     ransac_cfg: RansacConfig = RansacConfig(),
                     ba_cfg: BAConfig = BAConfig(num_fixed_poses=2),
                     max_tracks: int = 4096, seed: int = 0,
                     min_parallax_deg: float = 1.0,
                     prune_px: float = 3.0) -> SfmReconstruction:
    """Depth-free incremental SfM (VERDICT r4 task 4 — the real
    configs[2]+ capability; `reconstruct_rgbd` requires depth everywhere).

    Classic incremental pipeline from the repo's own primitives, no depth
    input anywhere:

      1. per-frame SIFT extract (one jitted compile);
      2. pairwise matches (i, i+1/i+2) -> feature tracks (union-find),
         edges filtered by essential-RANSAC inliers;
      3. two-view INIT on the consecutive pair with the most essential
         inliers: cheirality-checked (R, t) with |t| = 1 fixing the
         global gauge scale, midpoint triangulation seeds the landmarks;
      4. each remaining frame registers by PnP RANSAC against the
         current world landmarks (ops/pnp.py: non-minimal DLT + MSAC +
         LO-RANSAC previous-pose prior), then NEW tracks with two
         registered observations triangulate (widest-baseline pair,
         parallax-gated);
      5. global Schur BA -> reprojection pruning (weights zeroed, shapes
         static so BA compiles once) -> retriangulation of surviving
         landmarks from their widest live pair -> BA again.

    Returns poses/landmarks in the init pair's gauge (global scale is
    unobservable; evaluate with ate_rmse(..., with_scale=True)).
    """
    from ..ops.essential import find_essential
    from ..ops.pnp import find_pnp

    f = len(images)
    intr_np = np.asarray(intr, np.float32)
    fx, fy, cx, cy = intr_np
    intr_j = jnp.asarray(intr_np)
    key = jax.random.PRNGKey(seed)
    from .sift import extract as _extract

    feats = [ _extract(jnp.asarray(images[i]), sift_cfg) for i in range(f) ]
    xs = [np.asarray(fe.x) for fe in feats]
    ys = [np.asarray(fe.y) for fe in feats]
    valid = [np.asarray(fe.valid) for fe in feats]
    xn = [np.stack([(x - cx) / fx, (y - cy) / fy], -1).astype(np.float32)
          for x, y in zip(xs, ys)]

    n = sift_cfg.total_kpts
    uf = _UnionFind(f * n)
    slot = lambda fr, k: fr * n + k

    pairs = [(i, i + 1) for i in range(f - 1)] + \
            [(i, i + 2) for i in range(f - 2)]
    ess = {}
    for (a, b) in pairs:
        key, k = jax.random.split(key)
        m = match(feats[a].desc, feats[a].valid, feats[b].desc,
                  feats[b].valid, match_cfg)
        idx = np.asarray(m.idx)
        ok = np.asarray(m.ok) & valid[a] & valid[b][idx]
        res = find_essential(jnp.asarray(xn[a]),
                             jnp.asarray(xn[b][idx]),
                             jnp.asarray(ok), ransac_cfg, k)
        if not bool(res.ok):
            continue
        inl = np.asarray(res.inliers) & ok
        ess[(a, b)] = (np.asarray(res.r), np.asarray(res.t),
                       int(res.num_inliers), idx, inl)
        for ka in np.nonzero(inl)[0]:
            uf.union(slot(a, int(ka)), slot(b, int(idx[ka])))

    # ---- track table: root -> [(frame, slot)], >= 2 distinct frames ----
    members: dict[int, list] = {}
    for fr in range(f):
        for k in np.nonzero(valid[fr])[0]:
            members.setdefault(uf.find(slot(fr, int(k))),
                               []).append((fr, int(k)))
    tracks = []
    for m_ in members.values():
        frames_seen = {}
        for fr, k in sorted(m_):
            frames_seen.setdefault(fr, k)        # one obs per frame
        if len(frames_seen) >= 2:
            tracks.append(sorted(frames_seen.items()))
    tracks = tracks[:max_tracks]
    track_of = {}
    for li, obs in enumerate(tracks):
        for fr, k in obs:
            track_of[(fr, k)] = li
    l = len(tracks)

    # ---- two-view init on the best consecutive pair ----
    init_pair = max(((a, b) for (a, b) in ess if b == a + 1),
                    key=lambda p: ess[p][2], default=None)
    assert init_pair is not None, "mono SfM: no consecutive pair verified"
    a0, b0 = init_pair
    r01, t01 = ess[init_pair][0], ess[init_pair][1]   # |t| = 1 gauge
    poses_r = {a0: np.eye(3, dtype=np.float32)}
    poses_t = {a0: np.zeros(3, np.float32)}
    poses_r[b0] = r01.astype(np.float32)
    poses_t[b0] = t01.astype(np.float32)

    points = np.zeros((l, 3), np.float32)
    have_point = np.zeros(l, bool)
    min_cosp = np.cos(np.deg2rad(min_parallax_deg))

    def triangulate_tracks(which):
        """Triangulate tracks (ids) from their widest registered pair."""
        by_pair: dict[tuple, list] = {}
        for li in which:
            reg = [(fr, k) for fr, k in tracks[li] if fr in poses_r]
            if len(reg) < 2:
                continue
            (fa, ka), (fb, kb) = reg[0], reg[-1]
            by_pair.setdefault((fa, fb), []).append((li, ka, kb))
        for (fa, fb), items in by_pair.items():
            lis = np.array([i[0] for i in items])
            xa = xn[fa][[i[1] for i in items]]
            xb = xn[fb][[i[2] for i in items]]
            pw, za, zb, cosp = _triangulate_world(
                poses_r[fa], poses_t[fa], poses_r[fb], poses_t[fb], xa, xb)
            good = (za > 1e-6) & (zb > 1e-6) & (cosp < min_cosp)
            points[lis[good]] = pw[good]
            have_point[lis[good]] = True

    triangulate_tracks(range(l))

    # ---- incremental registration (outward from the init pair) ----
    order = ([*range(b0 + 1, f)] + [*range(a0 - 1, -1, -1)])
    for fr in order:
        # observations of already-triangulated tracks in this frame
        obs_mask = np.zeros(n, bool)
        pts_w = np.zeros((n, 3), np.float32)
        for k in np.nonzero(valid[fr])[0]:
            li = track_of.get((fr, int(k)))
            if li is not None and have_point[li]:
                obs_mask[k] = True
                pts_w[k] = points[li]
        # previous registered neighbour's pose as the LO-RANSAC prior
        prev = fr - 1 if fr > b0 else fr + 1
        init = ((jnp.asarray(poses_r[prev]), jnp.asarray(poses_t[prev]))
                if prev in poses_r else None)
        key, k2 = jax.random.split(key)
        res = find_pnp(jnp.asarray(pts_w), jnp.asarray(xn[fr]),
                       jnp.asarray(obs_mask), ransac_cfg, k2, init=init)
        if not bool(res.ok):
            # registration failure: carry the neighbour's pose (the BA
            # can still pull it if observations exist)
            res_r = poses_r.get(prev, np.eye(3, dtype=np.float32))
            res_t = poses_t.get(prev, np.zeros(3, np.float32))
        else:
            res_r, res_t = np.asarray(res.r), np.asarray(res.t)
        poses_r[fr] = res_r.astype(np.float32)
        poses_t[fr] = res_t.astype(np.float32)
        triangulate_tracks([li for li in range(l) if not have_point[li]])

    pr = np.stack([poses_r[i] for i in range(f)])
    pt = np.stack([poses_t[i] for i in range(f)])

    # ---- observation table (static shape through both BA rounds) ----
    cam_idx, pt_idx, uvs, ws = [], [], [], []
    for li, obs in enumerate(tracks):
        if not have_point[li]:
            continue
        for fr, k in obs:
            cam_idx.append(fr)
            pt_idx.append(li)
            uvs.append((xs[fr][k], ys[fr][k]))
            ws.append(1.0)
    cam_idx = np.array(cam_idx, np.int32)
    pt_idx = np.array(pt_idx, np.int32)
    uvs = np.array(uvs, np.float32).reshape(-1, 2)
    ws = np.array(ws, np.float32)

    # gauge: fix the init pair's cameras; reorder so they are poses 0/1
    # only when they already are (default path: a0 = 0) — otherwise fall
    # back to fixing pose 0 + unit-|t| gauge via num_fixed_poses=1
    nfix = 2 if (a0, b0) == (0, 1) else 1
    import dataclasses as _dc
    ba_cfg = _dc.replace(ba_cfg, num_fixed_poses=max(nfix, 1))

    def run_ba(pr, pt, points, ws):
        prob = BAProblem(
            poses_r=jnp.asarray(pr), poses_t=jnp.asarray(pt),
            points=jnp.asarray(points), intr=intr_j,
            cam_idx=jnp.asarray(cam_idx), pt_idx=jnp.asarray(pt_idx),
            uv=jnp.asarray(uvs), w=jnp.asarray(ws))
        res = bundle_adjust(prob, ba_cfg)
        return (np.asarray(res.poses_r), np.asarray(res.poses_t),
                np.asarray(res.points), res)

    pr, pt, points_ba, res = run_ba(pr, pt, points, ws)
    points[have_point] = points_ba[have_point]

    # ---- reprojection pruning + retriangulation + final BA round ----
    pc = np.einsum("oij,oj->oi", pr[cam_idx],
                   points[pt_idx]) + pt[cam_idx]
    z = np.maximum(pc[:, 2], 1e-9)
    proj = np.stack([pc[:, 0] / z * fx + cx, pc[:, 1] / z * fy + cy], -1)
    err = np.linalg.norm(proj - uvs, axis=-1)
    ws = ws * ((err < prune_px) & (pc[:, 2] > 1e-3)).astype(np.float32)
    # drop landmarks with < 2 surviving observations
    live_count = np.bincount(pt_idx, weights=ws, minlength=l)
    ws = ws * (live_count[pt_idx] >= 2)
    for i in range(f):
        poses_r[i], poses_t[i] = pr[i], pt[i]
    live = {li for li in range(l) if live_count[li] >= 2}
    have_point[:] = False
    for li in live:
        have_point[li] = True
    triangulate_tracks(live)
    pr2, pt2, points_ba, res = run_ba(pr, pt, points, ws)
    points[have_point] = points_ba[have_point]

    return SfmReconstruction(poses_r=pr2, poses_t=pt2, points=points,
                             ba=res, n_tracks=int(have_point.sum()),
                             n_obs=int((ws > 0).sum()))
