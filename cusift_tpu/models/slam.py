"""Keyframe RGB-D SLAM: tracking, keyframing, loop closure, pose graph.

New surface relative to the reference (SURVEY.md §0, BASELINE configs[3]):
cuSIFT provides extract/match/rigid-align; this module composes them into a
full SLAM system.  Design: every per-frame kernel (extract, match,
RANSAC, retrieval scoring) is a jitted static-shape program compiled once;
only the *decisions* (keyframe promotion, loop acceptance) run on the host.
Keyframe storage is a fixed-capacity ring of descriptor/geometry buffers so
nothing ever recompiles as the map grows.

Checkpoint/resume (SURVEY.md §5.3-5.4): the whole SlamState serialises to
one npz; `Slam.checkpoint` / `Slam.restore` give mid-sequence restart — the
failure-recovery story the fail-fast reference lacks entirely.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (MatchConfig, RansacConfig, SiftConfig, SlamConfig)
from ..data.evaluation import ate_rmse
from ..ops.geometry import backproject
from ..ops.match import MATCH_PRECISION, match
from ..ops.ransac import find_rigid
from ..config import BAConfig, PoseGraphConfig
from ..optim.lie import compose, inverse, se3_log
from ..optim.posegraph import (PoseGraph, lm_loop as pg_lm_loop,
                               optimize as pg_optimize)
from .local_ba import window_ba
from .sift import extract


@partial(jax.jit, static_argnames=("sift_cfg",))
def _extract_with_points(img, depth, intr, sift_cfg: SiftConfig):
    """Features + camera-frame 3D backprojections (z = 0 where invalid)."""
    f = extract(img, sift_cfg)
    xi = jnp.clip(jnp.round(f.x).astype(jnp.int32), 0, depth.shape[1] - 1)
    yi = jnp.clip(jnp.round(f.y).astype(jnp.int32), 0, depth.shape[0] - 1)
    d = depth[yi, xi] * f.valid
    pts = backproject(jnp.stack([f.x, f.y], -1), d,
                      intr[0], intr[1], intr[2], intr[3])
    return f, pts, (d > 1e-6) & f.valid


@partial(jax.jit, static_argnames=("match_cfg", "ransac_cfg"))
def _track(desc_a, valid_a, pts_a, desc_b, valid_b, pts_b,
           match_cfg: MatchConfig, ransac_cfg: RansacConfig, key):
    """Match frame A to frame B and fit rigid T with pts_b ~ R pts_a + t."""
    m = match(desc_a, valid_a, desc_b, valid_b, match_cfg)
    pb = pts_b[m.idx]
    ok = m.ok & valid_a & (pts_a[:, 2] > 1e-6) & (pb[:, 2] > 1e-6)
    rig = find_rigid(pts_a, pb, ok, ransac_cfg, key)
    return rig, m


@partial(jax.jit, static_argnames=("sift_cfg", "match_cfg", "ransac_cfg"))
def _frame_step(img, depth, intr, ref_desc, ref_valid, ref_pts,
                sift_cfg: SiftConfig, match_cfg: MatchConfig,
                ransac_cfg: RansacConfig, key):
    """One SLAM tracking step as a single XLA program.

    Bundles extract + match + rigid RANSAC + the keyframe-decision scalars
    into ONE dispatch with ONE packed scalar result ([21] floats): each
    host fetch waits for the device and pays a transfer's fixed latency,
    and the reference's per-stage readbacks (SURVEY.md §3.1) would cost
    3-4 fetches per frame.
    """
    f, pts, pvalid = _extract_with_points(img, depth, intr, sift_cfg)
    m = match(f.desc, f.valid, ref_desc, ref_valid, match_cfg)
    pb = ref_pts[m.idx]
    ok = m.ok & pvalid & (pb[:, 2] > 1e-6)
    rig = find_rigid(pts, pb, ok, ransac_cfg, key)
    # rig: X_ref = R X_cur + t  =>  T_cur<-ref = (R, t)^-1
    rel_r, rel_t = inverse(rig.r, rig.t)
    xi = se3_log(rel_r, rel_t)
    packed = jnp.concatenate([
        jnp.array([rig.num_inliers, rig.ok, f.valid.sum(), m.ok.sum()],
                  jnp.float32),
        rel_r.reshape(-1), rel_t, xi,
    ])                                                       # [4+9+3+6]
    return f, pts, packed


@partial(jax.jit, static_argnames=("sift_cfg", "match_cfg", "ransac_cfg"))
def _chunk_step(frames, intr, ref_desc, ref_valid, ref_pts,
                sift_cfg: SiftConfig, match_cfg: MatchConfig,
                ransac_cfg: RansacConfig, keys):
    """Track a [N, 2, H, W] frame chunk against ONE reference keyframe.

    vmap of _frame_step: one dispatch and ONE packed [N, 22] fetch per N
    frames, amortising the fixed per-fetch latency over the chunk.  The
    trade: keyframe
    promotions are replayed on the host after the fetch, so frames later
    in a chunk track against a (<= N-1 frames) older reference — still
    geometrically consistent, because each trajectory entry records which
    reference its relative pose is measured against.
    """
    def one(fr, k):
        return _frame_step(fr[0], fr[1], intr, ref_desc, ref_valid, ref_pts,
                           sift_cfg, match_cfg, ransac_cfg, k)

    return jax.vmap(one)(frames, keys)


@partial(jax.jit, static_argnames=("match_cfg", "ransac_cfg"))
def _retrieve_verify_step(desc, valid, pts, kf_desc, kf_valid, kf_pts,
                          lim_ex,
                          match_cfg: MatchConfig, ransac_cfg: RansacConfig,
                          key):
    """Retrieval + geometric verification of the best map candidate.

    One XLA program, one packed [16] result (cand, score, ok, inliers,
    R, t) — shared by loop closure and relocalisation so neither pays the
    score fetch + per-field rig fetches (~5 round-trips) of the split form.
    `lim_ex` is a [2] int32 device array (limit, exclude) building the
    active-keyframe mask on device: ONE packed upload, not two, since each
    small host->device transfer pays a fixed latency.
    """
    limit, exclude = lim_ex[0], lim_ex[1]
    idx = jnp.arange(kf_desc.shape[0])
    active = (idx < limit) & (idx != exclude)
    scores = _kf_scores(desc, valid, kf_desc, kf_valid, active)
    cand = jnp.argmax(scores)
    rig, _ = _track(desc, valid, pts, kf_desc[cand], kf_valid[cand],
                    kf_pts[cand], match_cfg, ransac_cfg, key)
    return jnp.concatenate([
        jnp.array([cand, scores[cand], rig.ok, rig.num_inliers],
                  jnp.float32),
        rig.r.reshape(-1), rig.t,
    ])


@jax.jit
def _permute_ring(desc, valid, pts, perm):
    """Ring-slot permutation as ONE dispatch.

    Three eager `x[perm]` gathers would be three dispatches, each of
    which can block behind the busy device queue; one jitted program is
    one dispatch.
    """
    return desc[perm], valid[perm], pts[perm]


@jax.jit
def _set_ring_row(desc, valid, pts, di, d, v, p):
    """Keyframe-ring row insert as ONE dispatch (same rationale)."""
    return (desc.at[di].set(d), valid.at[di].set(v), pts.at[di].set(p))


@partial(jax.jit, static_argnames=("w", "match_cfg", "ransac_cfg",
                                   "ba_cfg", "pg_cfg", "min_score",
                                   "min_inl"))
def _kf_event_step(kf_desc, kf_valid, kf_pts, intr, blob, key,
                   w: int, match_cfg: MatchConfig,
                   ransac_cfg: RansacConfig, ba_cfg: BAConfig,
                   pg_cfg: PoseGraphConfig, min_score: float,
                   min_inl: int):
    """The whole per-keyframe-insert backend as ONE program (round 5).

    Window BA -> loop-closure retrieval + geometric verification ->
    (conditionally) dense pose-graph solve, chained on device.  The split
    form runs these as three separate programs, each with its own uploads
    and fetches; this form pays ONE packed upload (poses + padded edge
    table, ints bitcast into the float blob) and ONE packed fetch (updated
    poses + decisions).

    Blob layout — ints (bitcast): [j, n_kf, e_cnt, lim] edge_i[E]
    edge_j[E]; floats: poses_r[K*9] poses_t[K*3] meas_r[E*9] meas_t[E*3]
    weight[E].  The candidate closure edge is appended at e_cnt with
    weight 2*accept (weight 0 = inert), so no host round-trip sits
    between verification and the graph solve.  Returns
    [poses_r K*9 | poses_t K*3 | cand score accept inl ba_c0 ba_c1 |
    rig_r 9 | rig_t 3].
    """
    kfcap = kf_desc.shape[0]
    ecap = (blob.shape[0] - 4 - 12 * kfcap) // 15
    ni = 4 + 2 * ecap
    ints = jax.lax.bitcast_convert_type(blob[:ni], jnp.int32)
    j, n_kf, e_cnt, lim = ints[0], ints[1], ints[2], ints[3]
    edge_i = ints[4:4 + ecap]
    edge_j = ints[4 + ecap:ni]
    o = ni

    def take(count, shape):
        nonlocal o
        out = blob[o:o + count].reshape(shape)
        o += count
        return out

    poses_r = take(kfcap * 9, (kfcap, 3, 3))
    poses_t = take(kfcap * 3, (kfcap, 3))
    meas_r = take(ecap * 9, (ecap, 3, 3))
    meas_t = take(ecap * 3, (ecap, 3))
    weight = take(ecap, (ecap,))

    # ---- sliding-window BA over the last w ring slots ----
    zero_c = jnp.zeros((), jnp.float32)
    if w >= 3:
        widx = jnp.clip(n_kf - w + jnp.arange(w), 0, kfcap - 1)
        wmask = jnp.ones(w, jnp.float32)

        def run_ba(pr, pt):
            r, t, c0, c1 = window_ba(
                kf_desc[widx], kf_valid[widx], kf_pts[widx],
                pr[widx], pt[widx], intr, wmask, match_cfg, ba_cfg)
            return pr.at[widx].set(r), pt.at[widx].set(t), c0, c1

        # gauge safety: only run once the window holds w REAL keyframes
        # (clamped duplicate indices would unfix the two-pose gauge)
        poses_r, poses_t, ba_c0, ba_c1 = jax.lax.cond(
            n_kf >= w, run_ba,
            lambda pr, pt: (pr, pt, zero_c, zero_c),
            poses_r, poses_t)
    else:
        ba_c0 = ba_c1 = zero_c

    # ---- loop-closure retrieval + geometric verification ----
    qd, qv, qp = kf_desc[j], kf_valid[j], kf_pts[j]

    def run_rv(key):
        active = jnp.arange(kfcap) < lim
        scores = _kf_scores(qd, qv, kf_desc, kf_valid, active)
        cand = jnp.argmax(scores)
        rig, _ = _track(qd, qv, qp, kf_desc[cand], kf_valid[cand],
                        kf_pts[cand], match_cfg, ransac_cfg, key)
        return (cand.astype(jnp.int32), scores[cand],
                rig.ok.astype(jnp.float32),
                rig.num_inliers.astype(jnp.float32), rig.r, rig.t)

    cand, score, rv_ok, inl, rig_r, rig_t = jax.lax.cond(
        lim > 0, run_rv,
        lambda key: (jnp.int32(0), jnp.float32(-jnp.inf), zero_c, zero_c,
                     jnp.eye(3, dtype=jnp.float32),
                     jnp.zeros(3, jnp.float32)),
        key)
    accept = ((lim > 0) & (rv_ok > 0) & jnp.isfinite(score)
              & (score >= min_score) & (inl >= min_inl))

    # ---- append the candidate edge; weight 0 keeps it inert ----
    edge_i = edge_i.at[e_cnt].set(cand)
    edge_j = edge_j.at[e_cnt].set(j)
    meas_r = meas_r.at[e_cnt].set(rig_r)
    meas_t = meas_t.at[e_cnt].set(rig_t)
    weight = weight.at[e_cnt].set(jnp.where(accept, 2.0, 0.0))

    # ---- pose-graph solve, only when the closure was accepted ----
    def solve(pr, pt):
        g = PoseGraph(poses_r=pr, poses_t=pt, edge_i=edge_i,
                      edge_j=edge_j, meas_r=meas_r, meas_t=meas_t,
                      weight=weight)
        res = pg_lm_loop(g, pg_cfg)
        return res.poses_r, res.poses_t

    poses_r, poses_t = jax.lax.cond(accept, solve,
                                    lambda pr, pt: (pr, pt),
                                    poses_r, poses_t)

    return jnp.concatenate([
        poses_r.reshape(-1), poses_t.reshape(-1),
        jnp.stack([cand.astype(jnp.float32), score,
                   accept.astype(jnp.float32), inl, ba_c0, ba_c1]),
        rig_r.reshape(-1), rig_t,
    ])


@jax.jit
def _kf_scores(query_desc, query_valid, kf_desc, kf_valid, kf_active):
    """[MAXKF] similarity of a query frame to every stored keyframe.

    Mean best-correlation over valid query descriptors — the bag-of-features
    retrieval proxy; runs as one batched matmul over the whole keyframe
    ring (the reference has no retrieval at all), at the matcher's TF32
    precision: a ranking proxy needs no more.
    """
    sim = jnp.einsum("nd,kmd->knm", query_desc, kf_desc,
                     precision=MATCH_PRECISION,
                     preferred_element_type=jnp.float32)
    sim = jnp.where(kf_valid[:, None, :], sim, -jnp.inf)
    best = jnp.max(sim, axis=-1)                                  # [KF, N]
    best = jnp.where(query_valid[None, :] & jnp.isfinite(best), best, 0.0)
    scores = jnp.sum(best, -1) / jnp.maximum(jnp.sum(query_valid), 1.0)
    return jnp.where(kf_active, scores, -jnp.inf)


@dataclasses.dataclass
class SlamState:
    """Fixed-capacity SLAM map (host-held, device-resident arrays)."""

    kf_desc: jnp.ndarray      # [KF, N, 128]
    kf_valid: jnp.ndarray     # [KF, N]
    kf_pts: jnp.ndarray       # [KF, N, 3] camera-frame backprojections
    # poses are host-side numpy: a per-frame pose update/read on device
    # arrays would be a device round-trip every frame; the pose-graph
    # optimiser converts to device arrays only when a loop closure fires
    kf_pose_r: np.ndarray     # [KF, 3, 3] world-to-camera
    kf_pose_t: np.ndarray     # [KF, 3]
    n_kf: int
    # pose-graph edges (host lists; bounded by frames processed)
    edge_i: list
    edge_j: list
    meas_r: list
    meas_t: list
    weight: list
    # trajectory: per processed frame (ref_kf, T_cur<-kf as (R, t), tracked)
    traj_ref: list
    traj_rel_r: list
    traj_rel_t: list
    traj_ok: list
    n_closures: int = 0
    n_window_ba: int = 0      # window-BA solves that ran (non-zero cost)
    n_kf_total: int = 0       # keyframes ever inserted (monotonic; n_kf
                              # pins at capacity once eviction starts)


class Slam:
    """Sequential RGB-D SLAM driver (BASELINE configs[3])."""

    def __init__(self, intr, sift_cfg=SiftConfig(), match_cfg=MatchConfig(),
                 ransac_cfg=RansacConfig(), slam_cfg=SlamConfig(),
                 pg_cfg=PoseGraphConfig(), seed: int = 0,
                 dist_ba: bool = False):
        self.intr = jnp.asarray(intr)
        self.sift_cfg = sift_cfg
        self.match_cfg = match_cfg
        self.ransac_cfg = ransac_cfg
        self.cfg = slam_cfg
        self.pg_cfg = pg_cfg
        # host-side counter PRNG: an eager jax.random.split is a device
        # dispatch plus fetch per call; distinct (seed, counter) raw
        # threefry keys are independent streams built on the host
        self._seed = seed
        self._key_ctr = 0
        n = sift_cfg.total_kpts
        kf = slam_cfg.max_keyframes
        eye = np.broadcast_to(np.eye(3, dtype=np.float32), (kf, 3, 3)).copy()
        self.state = SlamState(
            kf_desc=jnp.zeros((kf, n, 128)), kf_valid=jnp.zeros((kf, n), bool),
            kf_pts=jnp.zeros((kf, n, 3)), kf_pose_r=eye,
            kf_pose_t=np.zeros((kf, 3), np.float32), n_kf=0,
            edge_i=[], edge_j=[], meas_r=[], meas_t=[], weight=[],
            traj_ref=[], traj_rel_r=[], traj_rel_t=[], traj_ok=[])
        self.metrics: list[dict] = []
        # device-constant cache: every small host->device upload pays a
        # fixed transfer latency, so values that recur (ring indices,
        # retrieval masks, unit weights) are uploaded once and reused
        self._dev_cache: dict = {}
        # chunked-run in-flight reference slot holder (see _run_chunked)
        self._chunk_ref: list | None = None
        # deferred fused-event slot: [j, device_result, metric_rec]
        # last keyframe inserted within the CURRENT chunk, as its
        # relative pose against the chunk reference: re-gates later
        # in-chunk promotion decisions (see _commit)
        self._chunk_last_insert: tuple | None = None
        # (SlamConfig.defer_events; applied by _drain_event).  _defer_ok
        # gates deferral to the SEQUENTIAL path: in chunked runs the
        # pending event interleaves with the feeder thread's big chunk
        # uploads, so chunked runs drain each event eagerly
        self._pending_event: list | None = None
        self._defer_ok = True
        # optional per-frame callback (e.g. streaming JSONL metrics); called
        # with each record as soon as it is committed, so long runs keep
        # their observability even if interrupted
        self.on_metric = None
        # distributed local BA over all devices' "map" axis when requested
        # (BASELINE configs[4]'s streaming form); single-device otherwise
        self._ba_mesh = None
        if dist_ba and len(jax.devices()) > 1:
            from ..parallel.mesh import map_mesh
            self._ba_mesh = map_mesh()
        # fused per-insert backend (one dispatch + one fetch per keyframe
        # event): needs the newest-anchored single-device BA layout
        self._fused_events = (slam_cfg.fused_events
                              and slam_cfg.local_ba_anchor == "newest"
                              and self._ba_mesh is None)
        self._ba_cfg = BAConfig(max_iters=slam_cfg.local_ba_iters,
                                cg_iters=slam_cfg.local_ba_cg_iters,
                                num_fixed_poses=2, huber_delta=4.0)
        self._pg_dense = dataclasses.replace(pg_cfg, solver="dense")

    # ---------- keyframe management ----------

    def _dev(self, key, build):
        """Cached device upload of a recurring small constant."""
        v = self._dev_cache.get(key)
        if v is None:
            v = self._dev_cache[key] = jax.device_put(build())
        return v

    def _add_keyframe(self, desc, valid, pts, pose_r, pose_t) -> int:
        s = self.state
        i = s.n_kf
        assert i < self.cfg.max_keyframes, "keyframe capacity exceeded"
        # dynamic index: a Python int bakes into the compiled update as a
        # constant — one fresh XLA program per ring row over a long run;
        # cached device scalar — no fresh upload per insert
        di = self._dev(("i32", i), lambda: np.int32(i))
        s.kf_desc, s.kf_valid, s.kf_pts = _set_ring_row(
            s.kf_desc, s.kf_valid, s.kf_pts, di, desc, valid, pts)
        s.kf_pose_r[i] = np.asarray(pose_r)
        s.kf_pose_t[i] = np.asarray(pose_t)
        s.n_kf = i + 1
        s.n_kf_total += 1
        # cache the new reference's committed views.  The inserted arrays
        # ARE row i by value (no gather needed — three eager row gathers
        # would be three blocking dispatches), and they are
        # concrete device arrays, not lazy slices, so the next jitted
        # step's dispatch does not block on them.
        self._ref_cache = (i, desc, valid, pts)
        return i

    def _evict_keyframe(self):
        """Free one ring slot for a new keyframe; returns the slot or None.

        Victim policy (cfg.kf_evict): "redundant" removes the keyframe
        whose camera centre is closest to its temporal neighbours' —
        thinning dense stretches while keeping the map's spatial coverage,
        so revisited regions still retrieve for loop closure; nodes
        holding loop edges are protected (they anchor the optimised
        graph).  "oldest" removes the oldest evictable slot (FIFO /
        sliding-window semantics).  Slot 0 (the gauge origin) and the
        newest `local_ba_window` slots (the active BA window and tracking
        neighbourhood) are never evicted.
        """
        from .evict import select_victim
        s = self.state
        # a chunked run's in-flight reference keyframe must survive the
        # chunk (its packed measurements resolve through that slot)
        victim = select_victim(
            self.cfg.kf_evict, s.kf_pose_r, s.kf_pose_t, s.n_kf,
            guard=max(self.cfg.local_ba_window, 2),
            edges=zip(s.edge_i, s.edge_j, s.weight),
            pinned=self._chunk_ref[0] if self._chunk_ref is not None else -1)
        if victim is None:
            return None
        self._remove_keyframe_slot(victim)
        return victim

    def _remove_keyframe_slot(self, v: int):
        """Remove ring slot v, shifting slots above it down by one.

        Keeps slot index == temporal order (the invariant behind the
        local-BA window and the loop temporal gap).  Trajectory frames
        referenced to v are baked to ABSOLUTE world-to-camera poses at
        its current (post-optimisation) estimate and marked ref = -1;
        the victim's in/out edges are spliced into one composed edge
        (T_a T_v^-1 followed by T_v T_b^-1 composes exactly); remaining
        edges incident to v are dropped.
        """
        s = self.state
        rv, tv = s.kf_pose_r[v].copy(), s.kf_pose_t[v].copy()
        for i, ref in enumerate(s.traj_ref):
            if ref == v:
                s.traj_rel_t[i] = s.traj_rel_r[i] @ tv + s.traj_rel_t[i]
                s.traj_rel_r[i] = s.traj_rel_r[i] @ rv
                s.traj_ref[i] = -1
            elif ref > v:
                s.traj_ref[i] = ref - 1

        ins = [k for k in range(len(s.edge_i))
               if s.edge_j[k] == v and s.edge_i[k] != v]
        outs = [k for k in range(len(s.edge_i))
                if s.edge_i[k] == v and s.edge_j[k] != v]
        spliced = None
        if ins and outs:
            a, b = ins[0], outs[0]
            if s.edge_i[a] != s.edge_j[b]:
                spliced = (s.edge_i[a], s.edge_j[b],
                           s.meas_r[a] @ s.meas_r[b],
                           s.meas_r[a] @ s.meas_t[b] + s.meas_t[a],
                           min(s.weight[a], s.weight[b]))
        keep = [k for k in range(len(s.edge_i))
                if s.edge_i[k] != v and s.edge_j[k] != v]

        def shift(x):
            return x - 1 if x > v else x

        s.edge_i = [shift(s.edge_i[k]) for k in keep]
        s.edge_j = [shift(s.edge_j[k]) for k in keep]
        s.meas_r = [s.meas_r[k] for k in keep]
        s.meas_t = [s.meas_t[k] for k in keep]
        s.weight = [s.weight[k] for k in keep]
        if spliced is not None:
            self._add_edge(shift(spliced[0]), shift(spliced[1]),
                           spliced[2], spliced[3], spliced[4])

        # shift the device ring with one same-shape gather (indices are a
        # traced argument: no recompile per victim; cached device upload
        # per victim slot, not a fresh upload per eviction); stale data
        # parked in the freed top slot is overwritten by the next insert
        kfcap = self.cfg.max_keyframes
        pnp = np.concatenate(
            [np.arange(v), np.arange(v + 1, kfcap), [v]]).astype(np.int32)
        perm = self._dev(("perm", v, kfcap), lambda: pnp)
        s.kf_desc, s.kf_valid, s.kf_pts = _permute_ring(
            s.kf_desc, s.kf_valid, s.kf_pts, perm)
        s.kf_pose_r = s.kf_pose_r[pnp].copy()
        s.kf_pose_t = s.kf_pose_t[pnp].copy()
        s.n_kf -= 1
        ref = self._ref_cache[0]
        if ref > v:        # cached views are by value; only the index moves
            self._ref_cache = (ref - 1,) + self._ref_cache[1:]
        if self._chunk_ref is not None and self._chunk_ref[0] > v:
            self._chunk_ref[0] -= 1   # never == v: eviction pins it

    def _add_edge(self, i, j, rel_r, rel_t, weight=1.0):
        """Edge constraint: measured T_i * T_j^-1 (world-to-cam convention)."""
        s = self.state
        s.edge_i.append(int(i))
        s.edge_j.append(int(j))
        s.meas_r.append(np.asarray(rel_r))
        s.meas_t.append(np.asarray(rel_t))
        s.weight.append(float(weight))

    def _next_key(self):
        self._key_ctr += 1
        return jnp.asarray(np.array([self._seed, self._key_ctr],
                                    np.uint32))

    def _next_keys(self, n: int):
        """[n, 2] batch of fresh counter keys (one upload, no eager split)."""
        base = self._key_ctr + 1
        self._key_ctr += n
        return jnp.asarray(np.stack(
            [np.full(n, self._seed, np.uint32),
             np.arange(base, base + n, dtype=np.uint32)], -1))

    # ---------- main loop ----------

    def process_frame(self, img, depth) -> dict:
        """Track one RGB-D frame; returns per-frame metrics.

        One device dispatch + one 22-float fetch per frame (see
        _frame_step).  For sequences,
        prefer `run`, which overlaps the fetch of frame i with the device
        work of frame i+1.
        """
        if self.state.n_kf == 0:
            return self._bootstrap(img, depth)
        rec = self._commit(*self._dispatch(img, depth))
        # the public per-frame API keeps eager semantics: callers read
        # state (n_closures, poses) right after the call.  Deferral's
        # overlap win lives in the streaming run()/_run_chunked paths,
        # which drain lazily (SlamConfig.defer_events).
        self._drain_event()
        return rec

    def _sense(self, img, aux):
        """Features + camera-frame 3D points of one frame (override hook).

        `aux` is the per-frame companion input: the depth map here, the
        right image in the stereo subclass (models/stereo.py).
        """
        feats, pts, _ = _extract_with_points(jnp.asarray(img),
                                             jnp.asarray(aux), self.intr,
                                             self.sift_cfg)
        return feats, pts

    def _sense_step(self, img, aux, kd, kv, kp, key):
        """One fused track-against-reference dispatch (override hook)."""
        return _frame_step(jnp.asarray(img), jnp.asarray(aux), self.intr,
                           kd, kv, kp, self.sift_cfg, self.match_cfg,
                           self.ransac_cfg, key)

    def _chunk_sense_step(self, fchunk, kd, kv, kp, keys):
        """N-frame tracking dispatch against one reference (override hook).

        `fchunk` is the packed [N, 2, H, W] chunk (image+aux planes).
        """
        return _chunk_step(fchunk, self.intr, kd, kv, kp, self.sift_cfg,
                           self.match_cfg, self.ransac_cfg, keys)

    def _bootstrap(self, img, depth) -> dict:
        s = self.state
        feats, pts = self._sense(img, depth)
        i = self._add_keyframe(feats.desc, feats.valid, pts,
                               np.eye(3, dtype=np.float32),
                               np.zeros(3, np.float32))
        s.traj_ref.append(i)
        s.traj_rel_r.append(np.eye(3, dtype=np.float32))
        s.traj_rel_t.append(np.zeros(3, np.float32))
        s.traj_ok.append(True)
        rec = {"frame": 0, "kpts": int(feats.count), "matches": 0,
               "inliers": 0, "keyframe": True, "loop": False}
        self.metrics.append(rec)
        if self.on_metric:
            self.on_metric(rec)
        return rec

    def _dispatch(self, img, depth):
        """Enqueue one tracking step against the current reference keyframe.

        Returns (feats, pts, packed_device, ref) without any host sync —
        the caller chooses when to pay the fetch.
        """
        ref, kd, kv, kp = self._ref_cache
        feats, pts, packed = self._sense_step(img, depth, kd, kv, kp,
                                              self._next_key())
        return feats, pts, packed, ref

    def _commit(self, feats, pts, packed, ref, index=None) -> dict:
        """Fetch one step's packed scalars and apply the SLAM decisions.

        index selects one frame out of a chunked step's batched outputs —
        sliced LAZILY inside the keyframe branch, because eagerly slicing
        9 arrays per frame is 9 dispatches per frame and most frames never
        become keyframes.
        """
        s = self.state
        packed = np.asarray(packed)                      # the one fetch
        inl = int(packed[0])
        n_kpts = int(packed[2])
        n_matches = int(packed[3])
        rel_r = packed[4:13].reshape(3, 3)
        rel_t = packed[13:16]
        xi = packed[16:22]
        tracked = bool(packed[1]) and inl >= self.cfg.track_min_inliers

        relocalised = False
        if not tracked:
            # relocalisation: retrieve the most similar keyframe over the
            # WHOLE map and verify geometrically — the reference-keyframe
            # track just failed, but the frame may still see mapped space
            # (e.g. after occlusion or fast motion)
            if index is not None:
                feats = jax.tree.map(lambda a: a[index], feats)
                pts = pts[index]
                index = None
            reloc = self._try_relocalise(feats.desc, feats.valid, pts, ref)
            if reloc is not None:
                ref, rel_r, rel_t, inl = reloc
                tracked = True
                relocalised = True
                # motion magnitudes from the RECOVERED pose — xi belongs
                # to the failed track and is garbage here
                xi = np.zeros(6, np.float32)
                xi[:3] = rel_t
                cosang = np.clip((np.trace(rel_r) - 1.0) / 2.0, -1.0, 1.0)
                xi[3] = np.arccos(cosang)
                # rebase the tracking reference onto the recovered
                # keyframe so following frames track it directly, even
                # when the keyframe ring is full and nothing is inserted
                # (device-scalar index: python-int gathers compile one
                # program per slot value)
                dref = self._dev(("i32", ref), lambda: np.int32(ref))
                self._ref_cache = (ref, s.kf_desc[dref], s.kf_valid[dref],
                                   s.kf_pts[dref])
            else:
                # still lost: copy the previous frame's relative pose AND
                # its reference — in chunked runs `ref` may be stale (a
                # keyframe promoted earlier in the chunk), and the copied
                # pose is only meaningful against its own reference
                rel_r = np.asarray(s.traj_rel_r[-1])
                rel_t = np.asarray(s.traj_rel_t[-1])
                ref = int(s.traj_ref[-1])

        trans_mag = float(np.linalg.norm(xi[:3]))
        rot_mag = float(np.linalg.norm(xi[3:]))
        if (self._chunk_ref is not None and not relocalised
                and self._chunk_last_insert is not None):
            # chunked runs: xi measures motion against the reference
            # captured at DISPATCH, but a keyframe inserted earlier in
            # this chunk already covered part of it — re-gate against
            # the last in-chunk insert (free host 3x3 math) or the lag
            # promotes ~2x the keyframes a sequential run does, and
            # every extra keyframe is an extra fused event (76 vs 43
            # keyframes at chunk 8 in the round-5 profile, 62f0428)
            ri, ti = self._chunk_last_insert
            rel2_r = rel_r @ ri.T
            rel2_t = rel_t - rel2_r @ ti
            trans_mag = float(np.linalg.norm(rel2_t))
            cosang = np.clip((np.trace(rel2_r) - 1.0) / 2.0, -1.0, 1.0)
            rot_mag = float(np.arccos(cosang))
        need_kf = tracked and (
            inl < self.cfg.kf_min_inliers
            or trans_mag > self.cfg.kf_max_translation
            or rot_mag > self.cfg.kf_max_rotation)

        loop_found = False
        added_kf = False
        if need_kf:
            # a deferred event's solve must land before this insert reads
            # poses, evicts, or appends edges (SlamConfig.defer_events)
            self._drain_event()
            # pose of the new keyframe: T_cur<-w = T_cur<-ref * T_ref<-w —
            # computed BEFORE any eviction shifts the ring `ref` indexes
            # (host numpy 3x3 math: no device round-trip)
            pose_r = rel_r @ s.kf_pose_r[ref]
            pose_t = rel_r @ s.kf_pose_t[ref] + rel_t
            edge_ref = ref
            if s.n_kf >= self.cfg.max_keyframes:
                v = self._evict_keyframe()
                if v is not None:
                    if edge_ref == v:
                        edge_ref = -1      # odometry ref itself evicted
                    elif edge_ref > v:
                        edge_ref -= 1
            added_kf = s.n_kf < self.cfg.max_keyframes
        if added_kf:
            if index is not None:
                feats = jax.tree.map(lambda a: a[index], feats)
                pts = pts[index]
            desc, valid = feats.desc, feats.valid
            j = self._add_keyframe(desc, valid, pts, pose_r, pose_t)
            if edge_ref >= 0:
                # odometry edge ref -> j measured T_ref * T_j^-1
                o_r, o_t = rel_r.T, -(rel_r.T @ rel_t)
                self._add_edge(edge_ref, j, o_r, o_t, 1.0)
            if self._chunk_ref is not None:
                # a relocalised insert's relative pose is against the
                # RECOVERED keyframe, not the chunk reference — it
                # cannot seed the in-chunk re-gate composition
                self._chunk_last_insert = (None if relocalised else
                                           (np.asarray(rel_r),
                                            np.asarray(rel_t)))
            if self._fused_events:
                loop_found = self._kf_event(j)
            else:
                self._local_ba()
                loop_found = self._try_loop_closure(j, desc, valid, pts)
            s.traj_ref.append(j)
            s.traj_rel_r.append(np.eye(3, dtype=np.float32))
            s.traj_rel_t.append(np.zeros(3, np.float32))
        else:
            s.traj_ref.append(ref)
            s.traj_rel_r.append(np.asarray(rel_r))
            s.traj_rel_t.append(np.asarray(rel_t))
        s.traj_ok.append(tracked)

        rec = {"frame": len(s.traj_ref) - 1, "kpts": n_kpts,
               "matches": n_matches, "inliers": inl,
               "keyframe": bool(added_kf), "loop": bool(loop_found),
               "tracked": tracked, "relocalised": relocalised}
        if self._pending_event is not None and self._pending_event[2] is None:
            # this frame's own deferred event: patch rec["loop"] at drain
            self._pending_event[2] = rec
        self.metrics.append(rec)
        if self.on_metric:
            self.on_metric(rec)
        # only on a freshly-INSERTED keyframe — need_kf alone keeps firing
        # every frame once the keyframe ring is full
        if (added_kf and self.cfg.checkpoint_every
                and s.n_kf_total % self.cfg.checkpoint_every == 0):
            # cadence and name key on the MONOTONIC insert count: n_kf
            # pins at capacity once eviction starts, which would fire
            # every insert or never (and overwrite one file)
            self.checkpoint(f"slam_ckpt_{s.n_kf_total:04d}.npz")
        return rec

    def run(self, frames, max_frames: int | None = None,
            chunk: int = 1) -> list[dict]:
        """Process an iterable of (img, depth) pairs, fully pipelined.

        Uploads of frame i+1 run on a feeder thread during frame i's device
        work (utils/pipeline.py), so transfer latency hides behind compute
        instead of adding to every frame.

        chunk > 1 tracks N frames per dispatch with ONE scalar fetch
        (see _chunk_step): ~chunk-fold fewer host round-trips at the cost
        of keyframe decisions lagging by up to chunk-1 frames.  It pays
        where per-fetch latency, not transfer, dominates; which chunk
        wins on the GPU is not measured yet.
        """
        if chunk > 1:
            return self._run_chunked(frames, max_frames, chunk)
        self._defer_ok = True     # sequential path: deferral measured 1.4x
        from ..utils.pipeline import device_frames
        for i, f in enumerate(device_frames(frames)):
            if max_frames is not None and i >= max_frames:
                break
            if self.state.n_kf == 0:
                self._bootstrap(f[0], f[1])
                continue
            self._commit(*self._dispatch(f[0], f[1]))
        self._drain_event()   # callers read poses/closure counts next
        return self.metrics

    def _run_chunked(self, frames, max_frames, chunk: int) -> list[dict]:
        from ..utils.pipeline import device_chunks

        self._defer_ok = False    # see __init__: measured slower chunked
        it = iter(frames)
        if max_frames is not None and max_frames <= 0:
            return self.metrics
        if self.state.n_kf == 0:
            first = next(it, None)
            if first is None:
                return self.metrics
            self._bootstrap(jnp.asarray(first[0]), jnp.asarray(first[1]))
            if max_frames is not None:
                max_frames -= 1

        done = 0
        for fchunk, n_valid in device_chunks(it, chunk):
            if max_frames is not None:
                n_valid = min(n_valid, max_frames - done)
                if n_valid <= 0:
                    break
            ref, kd, kv, kp = self._ref_cache
            keys = self._next_keys(chunk)
            feats, pts, packed = self._chunk_sense_step(fchunk, kd, kv, kp,
                                                        keys)
            packed_np = np.asarray(packed)           # the one fetch
            # every frame of the chunk was measured against the keyframe
            # captured above, so its SLOT must stay resolvable across the
            # chunk: a mid-chunk keyframe insert can evict a slot and
            # shift indices, so eviction tracks this holder (decrementing
            # it on shifts and never choosing it as the victim)
            self._chunk_ref = holder = [ref]
            self._chunk_last_insert = None
            try:
                for i in range(n_valid):
                    self._commit(feats, pts, packed_np[i], holder[0],
                                 index=i)
            finally:
                self._chunk_ref = None
            done += n_valid
        return self.metrics

    def _retrieve_and_verify(self, desc, valid, pts, limit: int,
                             exclude: int, min_inliers: int):
        """Best-map-candidate retrieval + rigid verification.

        Returns (cand, r, t, inliers) with X_cand = R X_query + t, or
        None.  One dispatch + one 16-float fetch (_retrieve_verify_step).
        """
        if limit <= 0:
            return None
        s = self.state
        lim_ex = self._dev(("lim_ex", limit, exclude),
                           lambda: np.array([limit, exclude], np.int32))
        packed = np.asarray(_retrieve_verify_step(
            desc, valid, pts, s.kf_desc, s.kf_valid, s.kf_pts,
            lim_ex, self.match_cfg, self.ransac_cfg,
            self._next_key()))
        cand, score, ok, inl = (int(packed[0]), float(packed[1]),
                                bool(packed[2]), int(packed[3]))
        if (not ok or not np.isfinite(score)
                or score < self.cfg.loop_min_score
                or inl < min_inliers):
            return None
        return cand, packed[4:13].reshape(3, 3), packed[13:16], inl

    def _try_relocalise(self, desc, valid, pts, ref):
        """Relocalise against the map after a tracking failure.

        Returns (keyframe, rel_r, rel_t, inliers) — T_cur<-keyframe — or
        None.  Excludes `ref` (it just failed geometric tracking) and uses
        the STRICT loop_min_inliers gate: accepting a false positive here
        mutates the map, exactly like a loop closure.  The reference has
        nothing comparable (SURVEY.md §5.3: it fail-fasts).
        """
        res = self._retrieve_and_verify(desc, valid, pts, self.state.n_kf,
                                        ref, self.cfg.loop_min_inliers)
        if res is None:
            return None
        cand, r, t, inl = res
        return cand, r.T, -(r.T @ t), inl   # T_cur<-cand = (R, t)^-1

    def _try_loop_closure(self, j, desc, valid, pts) -> bool:
        """Retrieval + geometric verification + pose-graph update."""
        s = self.state
        limit = max(0, s.n_kf - 1 - self.cfg.loop_temporal_gap)
        res = self._retrieve_and_verify(desc, valid, pts, limit, -1,
                                        self.cfg.loop_min_inliers)
        if res is None:
            return False
        cand, r, t, _ = res
        # X_cand = R X_j + t  =>  edge cand -> j measured T_cand * T_j^-1
        self._add_edge(cand, j, r, t, 2.0)
        s.n_closures += 1
        self._optimize_graph()
        return True

    def _kf_event(self, j: int) -> bool:
        """Fused per-insert backend: BA + closure + graph, one round-trip.

        Packs the host-held poses and edge table into one blob (ints
        bitcast into the float array — one upload, not two dtype-split
        ones), dispatches `_kf_event_step`, fetches one
        packed result, and applies it: pose mirror refresh + the closure
        edge appended to the host lists when the device accepted it.
        Returns whether a loop closure fired.
        """
        s = self.state
        e = len(s.edge_i)
        # room for the speculative closure edge at slot e
        ecap = max(64, -(-(e + 1) // 64) * 64)
        pad = ecap - e
        kfcap = self.cfg.max_keyframes
        limit = max(0, s.n_kf - 1 - self.cfg.loop_temporal_gap)
        ints = np.concatenate([
            np.array([j, s.n_kf, e, limit], np.int32),
            np.asarray(s.edge_i, np.int32), np.zeros(pad, np.int32),
            np.asarray(s.edge_j, np.int32), np.zeros(pad, np.int32)])
        eyepad = np.broadcast_to(np.eye(3, dtype=np.float32), (pad, 3, 3))
        meas_r = (np.concatenate([np.stack(s.meas_r), eyepad]) if e
                  else eyepad.copy())
        meas_t = np.zeros((ecap, 3), np.float32)
        wts = np.zeros(ecap, np.float32)
        if e:
            meas_t[:e] = np.stack(s.meas_t)
            wts[:e] = s.weight
        blob = jnp.asarray(np.concatenate([
            ints.view(np.float32),
            s.kf_pose_r.ravel(), s.kf_pose_t.ravel(),
            meas_r.ravel(), meas_t.ravel(), wts,
        ]).astype(np.float32))                      # the one upload
        dev = _kf_event_step(
            s.kf_desc, s.kf_valid, s.kf_pts, self.intr, blob,
            self._next_key(), self.cfg.local_ba_window, self.match_cfg,
            self.ransac_cfg, self._ba_cfg, self._pg_dense,
            self.cfg.loop_min_score, self.cfg.loop_min_inliers)
        if self.cfg.defer_events and self._defer_ok:
            # lazy apply (SlamConfig.defer_events): the device runs the
            # event while the host streams the next frames; any reader
            # of pose/edge state drains first (_drain_event)
            self._pending_event = [j, dev, None]
            return False
        return self._apply_event(j, dev)

    def _apply_event(self, j: int, dev) -> bool:
        """Fetch one event's packed result and apply it to host state."""
        s = self.state
        kfcap = self.cfg.max_keyframes
        packed = np.asarray(dev)                    # the one fetch
        k9 = kfcap * 9
        k12 = kfcap * 12
        s.kf_pose_r = packed[:k9].reshape(kfcap, 3, 3).copy()
        s.kf_pose_t = packed[k9:k12].reshape(kfcap, 3).copy()
        cand, _score, accept, _inl, ba_c0 = packed[k12:k12 + 5]
        s.n_window_ba += int(ba_c0 > 0)
        if accept > 0:
            self._add_edge(int(cand), j,
                           packed[k12 + 6:k12 + 15].reshape(3, 3).copy(),
                           packed[k12 + 15:k12 + 18].copy(), 2.0)
            s.n_closures += 1
        return bool(accept > 0)

    def _drain_event(self):
        """Apply the pending deferred event, if any (idempotent)."""
        if self._pending_event is None:
            return
        j, dev, rec = self._pending_event
        self._pending_event = None
        accept = self._apply_event(j, dev)
        if rec is not None:
            rec["loop"] = accept

    def _local_ba(self):
        """Sliding-window BA over the last W keyframes (north-star BA step).

        One jitted dispatch + one packed pose fetch (window_ba); runs only
        once the window is full so the two oldest window poses are always
        distinct gauge anchors.  The LM loop accepts steps only when they
        reduce the reprojection cost, so a degenerate window (few shared
        landmarks) leaves the poses untouched rather than corrupting them.
        """
        w = self.cfg.local_ba_window
        s = self.state
        if w < 3 or s.n_kf < w:
            return
        idxs = np.arange(s.n_kf - w, s.n_kf)
        di = self._dev(("win", s.n_kf - w, s.n_kf),
                       lambda: idxs.astype(np.int32))
        ba_cfg = BAConfig(max_iters=self.cfg.local_ba_iters,
                          cg_iters=self.cfg.local_ba_cg_iters,
                          num_fixed_poses=2,
                          huber_delta=4.0)  # px: blunts misassociations
        # ONE packed upload for the window poses (r then t), sliced apart
        # on device — one transfer per keyframe insert, not two
        blob = jnp.asarray(np.concatenate(
            [s.kf_pose_r[idxs].ravel(), s.kf_pose_t[idxs].ravel()]))
        args = (s.kf_desc[di], s.kf_valid[di], s.kf_pts[di],
                blob[:w * 9].reshape(w, 3, 3),
                blob[w * 9:].reshape(w, 3),
                self.intr,
                self._dev(("ones", w), lambda: np.ones(w, np.float32)))
        anchor = self.cfg.local_ba_anchor
        if self._ba_mesh is not None and anchor == "newest":
            from ..parallel.dist_ba import window_ba_dist
            r, t, c0, c1 = window_ba_dist(*args, self._ba_mesh,
                                          self.match_cfg, ba_cfg)
        else:
            # "union" anchoring runs single-device even when a mesh
            # exists: the streaming distributed solver's static
            # landmark-colocated sharding needs the [W, N] grid layout
            # (config.py:SlamConfig.local_ba_anchor)
            r, t, c0, c1 = window_ba(*args, self.match_cfg, ba_cfg,
                                     anchor=anchor)
        packed = np.array(jnp.concatenate(
            [r.reshape(-1), t.reshape(-1),
             jnp.stack([c0, c1])]))                  # the one fetch
        s.kf_pose_r[idxs] = packed[:w * 9].reshape(w, 3, 3)
        s.kf_pose_t[idxs] = packed[w * 9:w * 12].reshape(w, 3)
        s.n_window_ba += int(packed[w * 12] > 0)

    def _optimize_graph(self):
        s = self.state
        if not s.edge_i:
            return
        # static edge buckets (multiple of 64, weight-0 identity padding):
        # otherwise every closure changes the edge count and recompiles the
        # whole pose-graph LM/CG program (models/odometry.py grew the same
        # guard after the 300-frame soak OOMed on per-closure compiles)
        e = len(s.edge_i)
        cap = max(64, -(-e // 64) * 64)
        pad = cap - e
        eye = np.broadcast_to(np.eye(3, dtype=np.float32), (pad, 3, 3))
        # TWO packed uploads (one int, one float) instead of seven —
        # each small host->device transfer pays a fixed latency and this
        # runs on every accepted loop closure
        iblob = jnp.asarray(np.concatenate(
            [np.array(s.edge_i, np.int32), np.zeros(pad, np.int32),
             np.array(s.edge_j, np.int32), np.zeros(pad, np.int32)]))
        n_kf = s.kf_pose_r.shape[0]
        fblob = jnp.asarray(np.concatenate([
            s.kf_pose_r.ravel(), s.kf_pose_t.ravel(),
            np.concatenate([np.stack(s.meas_r), eye]).ravel(),
            np.concatenate([np.stack(s.meas_t),
                            np.zeros((pad, 3), np.float32)]).ravel(),
            np.array(s.weight, np.float32), np.zeros(pad, np.float32),
        ]).astype(np.float32))
        o = 0

        def take(count, shape):
            nonlocal o
            out = fblob[o:o + count].reshape(shape)
            o += count
            return out

        g = PoseGraph(
            poses_r=take(n_kf * 9, (n_kf, 3, 3)),
            poses_t=take(n_kf * 3, (n_kf, 3)),
            edge_i=iblob[:cap], edge_j=iblob[cap:],
            meas_r=take(cap * 9, (cap, 3, 3)),
            meas_t=take(cap * 3, (cap, 3)),
            weight=take(cap, (cap,)),
        )
        res = pg_optimize(g, self.pg_cfg)
        # np.array, not np.asarray: the latter returns a READ-ONLY view of
        # the device buffer, and keyframe inserts mutate these in place
        s.kf_pose_r = np.array(res.poses_r)
        s.kf_pose_t = np.array(res.poses_t)

    # ---------- outputs ----------

    def trajectory(self):
        """Per-frame world-to-camera poses (after all optimisation)."""
        self._drain_event()
        s = self.state
        kr = s.kf_pose_r
        kt = s.kf_pose_t
        rs, ts = [], []
        for ref, rel_r, rel_t in zip(s.traj_ref, s.traj_rel_r, s.traj_rel_t):
            if ref < 0:
                # baked absolute pose: the reference keyframe was evicted
                # and this frame's pose froze at its final estimate
                rs.append(rel_r)
                ts.append(rel_t)
                continue
            r = rel_r @ kr[ref]
            t = rel_r @ kt[ref] + rel_t
            rs.append(r)
            ts.append(t)
        return np.stack(rs), np.stack(ts)

    def ate(self, gt_r, gt_t) -> float:
        est_r, est_t = self.trajectory()
        return ate_rmse(est_r, est_t, gt_r, gt_t)

    # ---------- checkpoint / resume ----------

    def checkpoint(self, path: str):
        self._drain_event()
        s = self.state
        np.savez_compressed(
            path,
            kf_desc=np.asarray(s.kf_desc), kf_valid=np.asarray(s.kf_valid),
            kf_pts=np.asarray(s.kf_pts), kf_pose_r=np.asarray(s.kf_pose_r),
            kf_pose_t=np.asarray(s.kf_pose_t), n_kf=s.n_kf,
            edge_i=np.array(s.edge_i, np.int32),
            edge_j=np.array(s.edge_j, np.int32),
            meas_r=np.stack(s.meas_r) if s.meas_r else np.zeros((0, 3, 3)),
            meas_t=np.stack(s.meas_t) if s.meas_t else np.zeros((0, 3)),
            weight=np.array(s.weight, np.float32),
            traj_ref=np.array(s.traj_ref, np.int32),
            traj_rel_r=np.stack(s.traj_rel_r) if s.traj_rel_r else np.zeros((0, 3, 3)),
            traj_rel_t=np.stack(s.traj_rel_t) if s.traj_rel_t else np.zeros((0, 3)),
            traj_ok=np.array(s.traj_ok, bool),
            n_closures=s.n_closures, n_kf_total=s.n_kf_total,
            key=np.array([self._seed, self._key_ctr], np.uint32),
        )

    def restore(self, path: str):
        self._drain_event()
        z = np.load(path)
        s = self.state
        s.kf_desc = jnp.asarray(z["kf_desc"])
        s.kf_valid = jnp.asarray(z["kf_valid"])
        s.kf_pts = jnp.asarray(z["kf_pts"])
        s.kf_pose_r = np.array(z["kf_pose_r"])
        s.kf_pose_t = np.array(z["kf_pose_t"])
        s.n_kf = int(z["n_kf"])
        s.edge_i = list(z["edge_i"])
        s.edge_j = list(z["edge_j"])
        s.meas_r = list(z["meas_r"])
        s.meas_t = list(z["meas_t"])
        s.weight = list(z["weight"])
        s.traj_ref = list(z["traj_ref"])
        s.traj_rel_r = list(z["traj_rel_r"])
        s.traj_rel_t = list(z["traj_rel_t"])
        s.traj_ok = list(z["traj_ok"])
        s.n_closures = int(z["n_closures"])
        # absent in pre-eviction checkpoints: fall back to the live count
        s.n_kf_total = int(z["n_kf_total"]) if "n_kf_total" in z else s.n_kf
        # key holds (seed, counter); pre-round-5 checkpoints stored a raw
        # split-chain key whose two words still seed a valid fresh stream
        self._seed = int(z["key"][0])
        self._key_ctr = int(z["key"][1])
        i = s.n_kf - 1
        di = self._dev(("i32", i), lambda: np.int32(i))
        self._ref_cache = (i, s.kf_desc[di], s.kf_valid[di], s.kf_pts[di])
