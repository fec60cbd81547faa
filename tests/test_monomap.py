"""Persistent-map scale anchoring (models/monomap.py + ops/pnp.py).

The structural fix for monocular scale drift (62f0428:BASELINE.md round-3 drift
campaign): localise frames against a persistent landmark map with PnP
instead of chaining per-pair depth-ratio scales.  These tests drive the
map machinery both standalone (insert -> localise round trip on synthetic
geometry) and end-to-end through MonoVO on the two-plane scene.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cusift_tpu.config import (MatchConfig, RansacConfig, SiftConfig,
                               VOConfig)
from cusift_tpu.data.evaluation import ate_rmse
from cusift_tpu.data.synthetic import two_plane_sequence
from cusift_tpu.models.monomap import (LandmarkMap, empty_map, insert_step,
                                       localize_step)
from cusift_tpu.models.odometry import MonoVO

SIFT = SiftConfig(max_kpts=384, max_kpts_per_octave=256, num_octaves=3,
                  upscale=False)


def _unit_desc(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 128)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_insert_then_localize_roundtrip():
    """Landmarks inserted at identity localise a moved camera exactly."""
    n, msize = 128, 512
    intr = jnp.asarray(np.array([200.0, 200.0, 160.0, 120.0], np.float32))
    desc = jnp.asarray(_unit_desc(n, 0))
    rng = np.random.default_rng(1)
    # camera-frame points at the identity pose: pixels + depths
    x = jnp.asarray(rng.uniform(40, 280, n).astype(np.float32))
    y = jnp.asarray(rng.uniform(30, 210, n).astype(np.float32))
    depth = jnp.asarray(rng.uniform(2.0, 6.0, n).astype(np.float32))
    valid = jnp.ones(n, bool)

    lmap = empty_map(msize)
    lmap = insert_step(lmap, desc, valid, jnp.ones(n, jnp.float32),
                       x, y, intr, depth, jnp.zeros(n, bool),
                       jnp.eye(3), jnp.zeros(3), jnp.int32(0), 256)
    assert int(lmap.valid.sum()) == n

    # observe the same landmarks from a translated+rotated camera
    ang = 0.05
    r = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    t = np.array([0.2, -0.1, 0.3], np.float32)
    pts_w = np.asarray(lmap.pos)[:n]
    pc = pts_w @ r.T + t
    fx, fy, cx, cy = np.asarray(intr)
    u = jnp.asarray(pc[:, 0] / pc[:, 2] * fx + cx)
    v = jnp.asarray(pc[:, 1] / pc[:, 2] * fy + cy)

    # pair_ok=False exercises the pure-PnP rescue path: the essential
    # pair "failed", so the full PnP pose is adopted at map scale
    mt = localize_step(
        desc, valid, u, v, intr,
        jnp.zeros(n, jnp.float32), jnp.zeros((n, 3), jnp.float32),
        jnp.bool_(False), jnp.eye(3), jnp.zeros(3),
        jnp.float32(0.3), jnp.float32(0.3),
        jnp.eye(3), jnp.zeros(3), jnp.eye(3), jnp.zeros(3),
        lmap, jnp.int32(1), jnp.int32(-5), jnp.int32(10),
        jnp.int32(2), jnp.int32(8), jnp.float32(0.4),
        MatchConfig(), RansacConfig(num_hypotheses=256),
        jax.random.PRNGKey(0))
    packed = np.asarray(mt.packed)
    assert packed[14] > 0.5, "PnP must accept"
    np.testing.assert_allclose(packed[:9].reshape(3, 3), r, atol=5e-3)
    np.testing.assert_allclose(packed[9:12], t, atol=1e-2)
    # seen epochs advanced for the inlier landmarks
    assert int((np.asarray(mt.lmap.seen) == 1).sum()) >= 0.8 * n


def test_refinement_folds_duplicate_matches_once():
    """Duplicate best-matches to one landmark count as ONE observation.

    The frame match is a per-query argmax, so several query slots can hit
    the same landmark; their triangulations share the pair's coherent
    error.  The running-mean fold must segment-mean them (nobs +1 per
    frame), not scatter-add per row — the naive scatter wipes the prior
    mean and matures the landmark on fewer independent pairs than
    `min_obs` demands.
    """
    n, msize = 96, 512
    intr = jnp.asarray(np.array([200.0, 200.0, 160.0, 120.0], np.float32))
    desc = jnp.asarray(_unit_desc(n, 7))
    rng = np.random.default_rng(8)
    x = jnp.asarray(rng.uniform(40, 280, n).astype(np.float32))
    y = jnp.asarray(rng.uniform(30, 210, n).astype(np.float32))
    depth0 = jnp.asarray(rng.uniform(2.0, 6.0, n).astype(np.float32))

    lmap = empty_map(msize)
    lmap = insert_step(lmap, desc, jnp.ones(n, bool),
                       jnp.ones(n, jnp.float32), x, y, intr, depth0,
                       jnp.zeros(n, bool), jnp.eye(3), jnp.zeros(3),
                       jnp.int32(0), n)
    nobs0 = np.asarray(lmap.nobs)

    # second view: every landmark observed TWICE (two query slots with the
    # same descriptor, +-0.3 px apart)
    ang = 0.04
    r = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    t = np.array([0.15, -0.05, 0.25], np.float32)
    pts_w = np.asarray(lmap.pos)[:n]
    pc = pts_w @ r.T + t
    fx, fy, cx, cy = np.asarray(intr)
    u = pc[:, 0] / pc[:, 2] * fx + cx
    v = pc[:, 1] / pc[:, 2] * fy + cy
    q_desc = jnp.asarray(np.repeat(np.asarray(desc), 2, axis=0))
    du = rng.uniform(-0.3, 0.3, 2 * n).astype(np.float32)
    dv = rng.uniform(-0.3, 0.3, 2 * n).astype(np.float32)
    qu = jnp.asarray(np.repeat(u, 2) + du)
    qv = jnp.asarray(np.repeat(v, 2) + dv)
    q_depth = jnp.asarray(np.repeat(pc[:, 2], 2).astype(np.float32))
    q_xyn = np.stack([(np.asarray(qu) - cx) / fx,
                      (np.asarray(qv) - cy) / fy], -1)
    q_pts = jnp.asarray(
        np.concatenate([q_xyn, np.ones_like(q_xyn[:, :1])], -1)
        * np.asarray(q_depth)[:, None])

    mt = localize_step(
        q_desc, jnp.ones(2 * n, bool), qu, qv, intr,
        q_depth, q_pts,
        jnp.bool_(True), jnp.asarray(r), jnp.asarray(t),
        jnp.float32(1.0), jnp.float32(1.0),
        jnp.eye(3), jnp.zeros(3), jnp.eye(3), jnp.zeros(3),
        lmap, jnp.int32(1), jnp.int32(-5), jnp.int32(10),
        jnp.int32(5), jnp.int32(8), jnp.float32(0.4),
        MatchConfig(), RansacConfig(num_hypotheses=256),
        jax.random.PRNGKey(3))

    inl = np.asarray(mt.inliers)
    assert inl.sum() >= n, "most duplicate observations should localise"
    d_nobs = np.asarray(mt.lmap.nobs) - nobs0
    assert d_nobs.max() == 1, \
        f"a frame must add at most one observation per landmark " \
        f"(max increment {d_nobs.max()})"
    assert (d_nobs >= 1).sum() >= 0.8 * n
    # refined positions stay a proper running mean: halfway between the
    # creation position and this frame's (near-exact) re-triangulation,
    # never extrapolated past the observations
    moved = np.linalg.norm(np.asarray(mt.lmap.pos)[:n] - pts_w, axis=-1)
    assert np.median(moved[d_nobs[:n] == 1]) < 0.05


@pytest.mark.slow
def test_map_anchor_survives_keyframe_ring_eviction():
    """Map-anchored VO keeps tracking when the keyframe ring evicts.

    Landmark `seen` epochs are keyframe indices that are deliberately NOT
    remapped on eviction (they only feed a recency window); this drives
    the combination end to end to show localisation and insertion stay
    sound while slots churn.
    """
    seq = two_plane_sequence(n_frames=14, h=240, w=320, seed=3,
                             near=3.0, far=6.0, motion_scale=0.6)
    vo_cfg = VOConfig(max_keyframes=5, kf_every=2, map_anchor=True,
                      map_size=2048, map_active_kf=8, map_insert_budget=256,
                      map_min_inliers=15, map_min_obs=2, map_min_anchor=8,
                      loop_temporal_gap=1000)
    vo = MonoVO(seq.intr, sift_cfg=SIFT,
                ransac_cfg=RansacConfig(inlier_thresh_epi=4e-3),
                vo_cfg=vo_cfg)
    est_r, est_t = vo.run(list(seq.images))
    assert len(est_r) == 14
    assert vo.n_kf == 5 and vo._kf_frame[-1] >= 10  # evictions happened
    assert all(s["ok"] or s["pnp_ok"] for s in vo.stats)
    assert sum(s["pnp_ok"] for s in vo.stats[3:]) >= 0.5 * len(vo.stats[3:])
    assert np.isfinite(est_t).all()


def test_insert_eviction_prefers_invalid_then_oldest():
    msize, n = 64, 32
    intr = jnp.asarray(np.array([200.0, 200.0, 160.0, 120.0], np.float32))
    lmap = empty_map(msize)
    args = dict(x=jnp.full(n, 100.0), y=jnp.full(n, 100.0), intr=intr,
                depth=jnp.full(n, 3.0),
                already_inlier=jnp.zeros(n, bool),
                pose_r=jnp.eye(3), pose_t=jnp.zeros(3))
    for epoch in range(3):
        lmap = insert_step(lmap, jnp.asarray(_unit_desc(n, epoch)),
                           jnp.ones(n, bool), jnp.ones(n, jnp.float32),
                           args["x"], args["y"], args["intr"], args["depth"],
                           args["already_inlier"], args["pose_r"],
                           args["pose_t"], jnp.int32(epoch), n)
    # 64 slots, 96 inserted: the oldest epoch is fully evicted
    seen = np.asarray(lmap.seen)[np.asarray(lmap.valid)]
    assert int(np.asarray(lmap.valid).sum()) == msize
    assert (seen >= 1).all()
    assert (seen == 2).sum() == n


@pytest.mark.slow
def test_mono_vo_map_anchor_tracks_sequence():
    """End-to-end: map-anchored MonoVO localises with PnP and stays tight."""
    seq = two_plane_sequence(n_frames=14, h=240, w=320, seed=3,
                             near=3.0, far=6.0, motion_scale=0.6)
    # engagement-friendly maturity gates: this test exercises the
    # MACHINERY (PnP takeover, depth re-anchoring) on a short run; the
    # conservative production defaults need longer landmark histories
    vo_cfg = VOConfig(max_keyframes=32, kf_every=2, map_anchor=True,
                      map_size=2048, map_active_kf=8, map_insert_budget=256,
                      map_min_inliers=15, map_min_obs=2, map_min_anchor=8,
                      loop_temporal_gap=1000)
    vo = MonoVO(seq.intr, sift_cfg=SIFT,
                ransac_cfg=RansacConfig(inlier_thresh_epi=4e-3),
                vo_cfg=vo_cfg)
    est_r, est_t = vo.run(list(seq.images))
    assert len(est_r) == 14
    # PnP must take over once landmarks exist (first keyframes land by
    # frame ~2; allow the bootstrap frames to ride the chain)
    pnp_frames = [s["pnp_ok"] for s in vo.stats]
    assert sum(pnp_frames[3:]) >= 0.7 * len(pnp_frames[3:])
    assert all(s["ok"] or s["pnp_ok"] for s in vo.stats)
    ate = ate_rmse(est_r, est_t, seq.poses_r, seq.poses_t, with_scale=True)
    path = np.linalg.norm(np.diff(
        -np.einsum("nij,ni->nj", seq.poses_r, seq.poses_t), axis=0),
        axis=-1).sum()
    # short-run no-harm guard: the chain itself measures ~13.9% of path on
    # this 14-frame scene (per-pair scale noise dominates both modes at
    # this length); the map's value is LONG-run drift containment
    # (tests/test_vo_sequence.py soak + 62f0428:BASELINE.md round-3 campaign)
    assert ate < 0.16 * path


@pytest.mark.slow
def test_map_anchor_checkpoint_resume_equivalence(tmp_path):
    """Resuming a map-anchored run reproduces the uninterrupted one.

    The checkpoint must carry the landmark table and the DEVICE pose
    state (localize_step composes the next pose from it on device) —
    without them a resumed run silently teleports to the origin.
    """
    seq = two_plane_sequence(n_frames=10, h=240, w=320, seed=3,
                             near=3.0, far=6.0, motion_scale=0.6)
    vo_cfg = VOConfig(max_keyframes=32, kf_every=2, map_anchor=True,
                      map_size=1024, map_active_kf=8, map_insert_budget=128,
                      map_min_inliers=15, map_min_obs=2, map_min_anchor=8,
                      loop_temporal_gap=1000)

    def make():
        return MonoVO(seq.intr, sift_cfg=SIFT,
                      ransac_cfg=RansacConfig(inlier_thresh_epi=4e-3),
                      vo_cfg=vo_cfg)

    full = make()
    for img in seq.images[:6]:
        full.process(img)
    ckpt = str(tmp_path / "vo_map.npz")
    full.checkpoint(ckpt)
    for img in seq.images[6:]:
        full.process(img)
    er_a, et_a = full.trajectory()

    resumed = make()
    resumed.restore(ckpt)
    assert int(resumed._lmap.valid.sum()) > 0, "landmark table restored"
    for img in seq.images[6:]:
        resumed.process(img)
    er_b, et_b = resumed.trajectory()
    np.testing.assert_allclose(et_b, et_a, atol=1e-5)
    np.testing.assert_allclose(er_b, er_a, atol=1e-5)
