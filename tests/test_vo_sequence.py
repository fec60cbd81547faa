"""Sequence-scale monocular VO: keyframes, loop closure, bounded drift.

Round-3 soak scenario (VERDICT task 3 / BASELINE configs[4]): a long
synthetic two-plane circuit with a deliberate loop and a low-texture
blur burst, driven through the sequence-scale MonoVO frontend
(keyframe ring + essential loop closure + Sim(3) pose graph,
models/odometry.py).  Small renders keep CPU wall-time sane; the
real-chip long-run numbers live in 62f0428:BASELINE.md.
"""

import numpy as np
import pytest

from cusift_tpu.config import (MatchConfig, PoseGraphConfig, RansacConfig,
                               SiftConfig, VOConfig)
from cusift_tpu.data.evaluation import ate_rmse, kitti_drift, \
    trajectory_path_length
from cusift_tpu.data.synthetic import two_plane_sequence
from cusift_tpu.models.odometry import MonoVO

# 240x320 renders: the scale chain's depth-ratio median needs real
# triangulation parallax (per-frame baseline ~0.09 m against 3-6 m planes
# and ~2.5 px of image motion); 160x224 puts the estimator below its SNR
# floor and the chain random-walks (see round-3 build notes)
SIFT = SiftConfig(max_kpts=384, max_kpts_per_octave=256, num_octaves=3)


def _drift_pct(est_r, est_t, gt_r, gt_t):
    """Scale-aligned KITTI drift % over sub-path lengths of the run."""
    from cusift_tpu.data.evaluation import camera_centers, horn_align
    s, _, _ = horn_align(camera_centers(est_r, est_t),
                         camera_centers(gt_r, gt_t), with_scale=True)
    est_t = (est_t * s).astype(np.float32)
    total = trajectory_path_length(gt_r, gt_t)[-1]
    t_pc, _ = kitti_drift(est_r, est_t, gt_r, gt_t,
                          lengths=(0.25 * total, 0.5 * total), step=2)
    return t_pc


@pytest.mark.slow
def test_long_loop_sequence_bounded_drift():
    """300-frame circuit: loop closures fire and drift stays bounded."""
    seq = two_plane_sequence(n_frames=300, h=240, w=320, seed=3,
                             motion_scale=0.9, path="loop", amplitude=6.0)
    vo_cfg = VOConfig(max_keyframes=96, kf_every=4, loop_temporal_gap=30,
                      loop_min_inliers=25, loop_min_score=0.05,
                      loop_min_common=8)
    # ba_window=4: the production configs[4] shape (windowed BA in the
    # streaming loop) — measured t_pct 37.6 vs 43.4 without BA on this
    # scenario (scripts/diag_drift.py, 62f0428:BASELINE.md round-3 notes)
    vo = MonoVO(seq.intr, sift_cfg=SIFT, vo_cfg=vo_cfg, ba_window=4)
    er, et = vo.run(iter(seq.images))

    n_ok = sum(1 for s in vo.stats if s["ok"])
    assert n_ok >= 0.9 * len(vo.stats)
    assert vo.n_kf >= 20
    assert vo.n_closures >= 1, "deliberate loop must be closed"
    ate = ate_rmse(er, et, seq.poses_r, seq.poses_t, with_scale=True)
    path = trajectory_path_length(seq.poses_r, seq.poses_t)[-1]
    # bounded drift: Sim3 ATE under 8% of path, and the closures must
    # IMPROVE on the raw chain (measured 7.3% vs 9.3% raw once the
    # genuine revisit verifies — top-3 retrieval + wide temporal gap +
    # H/E planar guard; see 62f0428:BASELINE.md round-3 notes)
    assert ate < 0.08 * path, (ate, path)
    raw_r, raw_t = np.stack(vo.poses_r), np.stack(vo.poses_t)
    ate_raw = ate_rmse(raw_r, raw_t, seq.poses_r, seq.poses_t,
                       with_scale=True)
    assert ate < ate_raw * 0.85, (ate, ate_raw)
    # KITTI segment drift over 1/4- and 1/2-path subsequences.  The bound
    # is the MEASURED level of the pair-chained mono scale architecture
    # (37.6% with windowed BA), not an aspiration: per-pair scale error is
    # coherent (shared motion-estimate error) and random-walks through the
    # chain, and a Sim(3) graph can only pin it at closures — mid-loop
    # segments keep the wobble.  Measured-and-rejected fixes (all made it
    # WORSE; scripts/diag_drift.py): SVO-style per-slot depth filtering
    # (49%: poisons the closure epoch-scale observable), BA |t| scale
    # resync ungated/health-gated (55%/60%: low-parallax windows inject
    # garbage scale), 1.5x/pair smooth-motion clamp (42%: lags real speed
    # changes).  The structural fix — persistent-map scale anchoring — is
    # the round-4 item; this guard holds the measured line meanwhile.
    t_pc = _drift_pct(er, et, seq.poses_r, seq.poses_t)
    assert np.isfinite(t_pc) and t_pc < 45.0, t_pc


@pytest.mark.slow
def test_scale_recovery_after_blur_burst():
    """A low-texture burst breaks the scale chain; it must re-lock after.

    The per-pair scale freezes at prev_scale through the burst
    (scale_common < 8); afterwards the chain re-anchors from fresh
    triangulations.  Asserts the post-burst segment still tracks and the
    full-trajectory ATE stays bounded (no runaway scale).
    """
    burst = tuple(range(30, 36))
    seq = two_plane_sequence(n_frames=70, h=240, w=320, seed=5,
                             motion_scale=0.8, path="sweep", amplitude=8.0,
                             blur_frames=burst, blur_sigma=6.0)
    vo = MonoVO(seq.intr, sift_cfg=SIFT)
    er, et = vo.run(iter(seq.images))

    stats = vo.stats  # stats[i] covers pair (i, i+1)
    post = stats[40:]
    assert sum(1 for s in post if s["ok"]) >= 0.8 * len(post)
    # scale chain re-locks: tracked-depth overlap returns above the gate
    assert max(s["scale_common"] for s in post) >= 8
    ate = ate_rmse(er, et, seq.poses_r, seq.poses_t, with_scale=True)
    path = trajectory_path_length(seq.poses_r, seq.poses_t)[-1]
    assert ate < 0.12 * path, (ate, path)


def test_keyframe_ring_overflow_graceful():
    """At max_keyframes the map stops growing but odometry continues."""
    seq = two_plane_sequence(n_frames=14, h=240, w=320, seed=7,
                             motion_scale=0.8, amplitude=2.0)
    vo_cfg = VOConfig(max_keyframes=3, kf_every=2, loop_temporal_gap=50,
                      kf_evict="none")
    vo = MonoVO(seq.intr, sift_cfg=SIFT, vo_cfg=vo_cfg)
    er, et = vo.run(iter(seq.images))
    assert vo.n_kf == 3
    assert len(er) == 14
    n_ok = sum(1 for s in vo.stats if s["ok"])
    assert n_ok >= 0.8 * len(vo.stats)


def test_keyframe_ring_overflow_evicts_and_keeps_inserting():
    """Default eviction: the ring stays at capacity but keeps ingesting."""
    seq = two_plane_sequence(n_frames=14, h=240, w=320, seed=7,
                             motion_scale=0.8, amplitude=2.0)
    vo_cfg = VOConfig(max_keyframes=5, kf_every=2, loop_temporal_gap=50)
    vo = MonoVO(seq.intr, sift_cfg=SIFT, vo_cfg=vo_cfg)
    er, et = vo.run(iter(seq.images))
    assert vo.n_kf == 5
    # with kf_every=2 over 14 frames ~7 keyframes are promoted: the later
    # ones must land (ring newest advances past the fill point)
    assert vo._kf_frame[-1] >= 10
    assert len(vo._kf_frame) == 5
    assert sorted(vo._kf_frame) == vo._kf_frame  # temporal order kept
    assert len(er) == 14 and np.isfinite(et).all()
    n_ok = sum(1 for s in vo.stats if s["ok"])
    assert n_ok >= 0.8 * len(vo.stats)


def test_mono_remove_keyframe_slot_splices_sim3_edges():
    """_remove_keyframe_slot: edge splice composes Sim(3), refs remap."""
    intr = np.array([200.0, 200.0, 160.0, 120.0], np.float32)
    vo = MonoVO(intr, sift_cfg=SIFT,
                vo_cfg=VOConfig(max_keyframes=8, loop_temporal_gap=50))

    def rot_z(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)

    vo._kf_pose_r = np.zeros((8, 3, 3), np.float32)
    vo._kf_pose_t = np.zeros((8, 3), np.float32)
    poses = []
    for i in range(5):
        r, t = rot_z(0.1 * i), np.array([i, 0.1 * i, 0], np.float32)
        poses.append((r, t))
        vo._kf_pose_r[i] = r
        vo._kf_pose_t[i] = t
        vo._kf_frame.append(2 * i)
        if i:
            rp, tp = poses[i - 1]
            m_r = rp @ r.T
            s_m = 1.0 + 0.1 * i          # non-unit edge scales
            vo._edges.append((i - 1, i, m_r, tp - m_r @ t, s_m, 1.0))
    vo.n_kf = 5
    vo._frame_ref = [0, 1, 2, 2, 3, 4]

    vo._remove_keyframe_slot(2)

    assert vo.n_kf == 4
    assert vo._frame_ref == [0, 1, 1, 1, 2, 3]
    assert vo._kf_frame == [0, 2, 6, 8]
    pairs = sorted((e[0], e[1]) for e in vo._edges)
    assert pairs == [(0, 1), (1, 2), (2, 3)]
    spliced = [e for e in vo._edges if (e[0], e[1]) == (1, 2)][0]
    # edges (1,2,s=1.2) and (2,3,s=1.3): compose to scale 1.56 and
    # T_1 T_3^-1 rotation/translation via the Sim(3) chain
    r12 = poses[1][0] @ poses[2][0].T
    t12 = poses[1][1] - r12 @ poses[2][1]
    r23 = poses[2][0] @ poses[3][0].T
    t23 = poses[2][1] - r23 @ poses[3][1]
    np.testing.assert_allclose(spliced[2], r12 @ r23, atol=1e-6)
    np.testing.assert_allclose(spliced[3], 1.2 * (r12 @ t23) + t12, atol=1e-5)
    assert abs(spliced[4] - 1.2 * 1.3) < 1e-6
    # ring pose arrays shifted
    np.testing.assert_allclose(vo._kf_pose_r[2], poses[3][0], atol=1e-6)
    np.testing.assert_allclose(vo._kf_pose_t[3], poses[4][1], atol=1e-6)


@pytest.mark.slow
def test_long_poisoned_soak_correction_never_worse_than_raw():
    """1000-frame sub-SNR regime (VERDICT r3 task 3): the scale chain
    collapses coherently and poisons the loop edges' med_b/med_a scale
    observables — round 3 measured the Sim(3) CORRECTION ending worse
    than raw (ATE 14.7% vs 11.0% of path).  Round 4's two fixes must
    hold the line: the speed-dispersion health gate rejects the poisoned
    solves (measured: 8 rejects in the collapse window) and keyframes
    inserted after a solve inherit their predecessor's correction (the
    identity-row tail was half the damage).  The engine must never ship
    an output layer that degrades its input."""
    seq = two_plane_sequence(n_frames=1000, h=240, w=320, seed=3,
                             motion_scale=0.9, path="loop", amplitude=20.0)
    vo_cfg = VOConfig(max_keyframes=64, kf_every=4, loop_temporal_gap=30,
                      loop_min_inliers=25, loop_min_score=0.05,
                      loop_min_common=8)
    vo = MonoVO(seq.intr, sift_cfg=SIFT, vo_cfg=vo_cfg)
    er, et = vo.run(iter(seq.images))

    assert vo.n_closures >= 20          # the regime actually closes loops
    # VERDICT r4 task 3: the regime used to lose a third of its frames
    # (673/1000 tracked) to essential failures; the PnP rescue
    # (VOConfig.pnp_rescue, tests/test_pnp_rescue.py) must recover them
    tracked = sum(1 for s in vo.stats if s["ok"])
    assert tracked >= 850, f"tracked {tracked}/1000"
    ate = ate_rmse(er, et, seq.poses_r, seq.poses_t, with_scale=True)
    raw_r, raw_t = np.stack(vo.poses_r), np.stack(vo.poses_t)
    ate_raw = ate_rmse(raw_r, raw_t, seq.poses_r, seq.poses_t,
                       with_scale=True)
    # the hard guarantee: corrected never worse than raw (measured
    # 4.468 vs 4.471 — essentially raw, vs 5.87 in round 3)
    assert ate <= ate_raw * 1.02 + 1e-6, (ate, ate_raw)
    t_corr = _drift_pct(er, et, seq.poses_r, seq.poses_t)
    t_raw = _drift_pct(raw_r, raw_t, seq.poses_r, seq.poses_t)
    assert t_corr <= t_raw * 1.05 + 1e-6, (t_corr, t_raw)


def test_corr_inheritance_on_insert():
    """Keyframes inserted after a Sim(3) solve inherit the predecessor's
    correction through the raw relative motion (without this, frames
    riding them compose relative-as-absolute garbage — the round-3
    1000-frame corrected tail)."""
    intr = np.array([200.0, 200.0, 160.0, 120.0], np.float32)
    vo = MonoVO(intr, sift_cfg=SIFT,
                vo_cfg=VOConfig(max_keyframes=8, loop_temporal_gap=50))

    def rot_z(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)

    # seed one keyframe + a stored correction for it
    n = vo.sift_cfg.total_kpts
    vo._feats = vo._unpack_feats(np.zeros((n, 136), np.float32))
    vo._depth = np.zeros(n, np.float32)
    vo.poses_r = [np.eye(3, dtype=np.float32)]
    vo.poses_t = [np.zeros(3, np.float32)]
    assert vo._insert_keyframe()
    kf = 8
    cr = np.broadcast_to(np.eye(3, dtype=np.float32), (kf, 3, 3)).copy()
    ct = np.zeros((kf, 3), np.float32)
    cs = np.ones(kf, np.float32)
    cr[0] = rot_z(0.3)
    ct[0] = np.array([1.0, 2.0, 3.0], np.float32)
    cs[0] = 2.0
    vo._corr = (cr, ct, cs)

    # advance the raw chain and insert keyframe 1
    r1, t1 = rot_z(0.1), np.array([0.5, 0.0, 0.1], np.float32)
    vo.poses_r.append(r1)
    vo.poses_t.append(t1)
    assert vo._insert_keyframe()
    vo._frame_ref = [0, 1]   # frame k rides keyframe k (as process() sets)
    cr2, ct2, cs2 = vo._corr
    r_rel = r1 @ np.eye(3, dtype=np.float32).T
    t_rel = t1 - r_rel @ np.zeros(3, np.float32)
    np.testing.assert_allclose(cr2[1], r_rel @ cr[0], atol=1e-6)
    np.testing.assert_allclose(ct2[1], r_rel @ ct[0] + t_rel, atol=1e-6)
    assert cs2[1] == cs[0]
    # trajectory() at the new keyframe composes the inherited correction
    rs, ts = vo.trajectory()
    np.testing.assert_allclose(rs[1], r_rel @ cr[0], atol=1e-6)
    np.testing.assert_allclose(
        ts[1], r_rel @ (ct[0] / cs[0]) + t_rel / cs[0], atol=1e-6)


@pytest.mark.slow
def test_mono_windowed_ba_reduces_drift():
    """The mono BA accuracy win, end-to-end (VERDICT r3 task 5: the SLAM
    side had a BA-improves assertion, the mono side only a no-worse
    guard).  On a 100-frame drift-prone loop the windowed BA measurably
    reduces both ATE and KITTI segment drift (measured: ATE 10.23% ->
    8.74% of path, t_pct 36.2 -> 26.0)."""
    seq = two_plane_sequence(n_frames=100, h=240, w=320, seed=3,
                             motion_scale=0.9, path="loop", amplitude=6.0)
    vo_cfg = VOConfig(max_keyframes=96, kf_every=4, loop_temporal_gap=30,
                      loop_min_inliers=25, loop_min_score=0.05,
                      loop_min_common=8)

    def run(w):
        vo = MonoVO(seq.intr, sift_cfg=SIFT, vo_cfg=vo_cfg, ba_window=w)
        er, et = vo.run(iter(seq.images))
        ate = ate_rmse(er, et, seq.poses_r, seq.poses_t, with_scale=True)
        return float(ate), _drift_pct(er, et, seq.poses_r, seq.poses_t)

    ate0, t0 = run(0)
    ate4, t4 = run(4)
    assert ate4 < ate0 * 0.95, (ate4, ate0)
    assert t4 < t0 * 0.85, (t4, t0)


def test_speed_dispersion_gate_observable():
    """The Sim(3) gate's signal separates a genuine drift correction from
    a poisoned one: a correction whose node scales RESTORE a uniform
    camera speed lowers the log-speed dispersion; one that injects a
    bogus scale step raises it."""
    rng = np.random.default_rng(0)
    n = 20
    frames = list(range(0, 4 * n, 4))
    pose_r = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy()
    # raw chain: camera walks +x at a drifting scale (multiplicative
    # random walk) — centres c = -t for identity rotations
    step = np.exp(np.cumsum(rng.normal(0, 0.08, n)))
    cx = np.cumsum(step)
    pose_t = np.zeros((n, 3), np.float32)
    pose_t[:, 0] = -cx
    sig_raw = MonoVO._speed_dispersion(pose_r, pose_t, None, frames)

    # genuine correction: node scales equal to the accumulated drift, so
    # corrected centres advance uniformly -> dispersion collapses
    scales = np.zeros(n, np.float32)
    uniform = np.arange(1, n + 1, dtype=np.float32)
    scales = (cx / uniform).astype(np.float32)
    sig_good = MonoVO._speed_dispersion(pose_r, pose_t, scales, frames)
    assert sig_good < 0.25 * sig_raw, (sig_good, sig_raw)

    # poisoned correction: an x8 scale step mid-chain (the 1000-frame
    # soak's chain-collapse observable applied as a node scale)
    bad = np.ones(n, np.float32)
    bad[n // 2:] = 8.0
    sig_bad = MonoVO._speed_dispersion(pose_r, pose_t, bad, frames)
    assert sig_bad > 1.5 * sig_raw, (sig_bad, sig_raw)


def test_keyframe_referenced_tracking_mode():
    """track_ref="keyframe": frames track the last keyframe, not the
    previous frame — the pair baseline grows ~kf_every-fold and the scale
    chain steps once per keyframe.  Ships opt-in: measured ~parity with
    the prev-frame chain on the synthetic soaks (62f0428:BASELINE.md), where the
    wider baseline's parallax gain is offset by reduced match overlap."""
    seq = two_plane_sequence(n_frames=16, h=240, w=320, seed=3,
                             motion_scale=0.9, path="loop", amplitude=6.0)
    vo_cfg = VOConfig(track_ref="keyframe", kf_every=4,
                      loop_temporal_gap=100)
    vo = MonoVO(seq.intr, sift_cfg=SIFT, vo_cfg=vo_cfg)
    er, et = vo.run(iter(seq.images))
    assert len(er) == 16
    n_ok = sum(1 for s in vo.stats if s["ok"])
    assert n_ok >= 0.85 * len(vo.stats)
    # the second keyframe is forced on the first tracked frame (the
    # reference needs depth before scale is measurable)
    assert vo._kf_frame[0] == 0 and vo._kf_frame[1] == 1
    ate = ate_rmse(er, et, seq.poses_r, seq.poses_t, with_scale=True)
    path = trajectory_path_length(seq.poses_r, seq.poses_t)[-1]
    assert ate < 0.2 * path, (ate, path)
    assert np.isfinite(et).all()


def test_sim3_gate_matrix_healthy_poisoned_stopgo():
    """Gate decision matrix (VERDICT r4 task 5): healthy drift fix ->
    accept; poisoned chain-collapse solve -> reject; genuine correction
    on a STOP-AND-GO scene whose raw drift coincidentally smoothed the
    speed profile -> accept (the absolute speed route alone would
    falsely reject it; the motion-free smoothness route rescues it);
    abrupt-but-genuine blur-burst-style re-lock -> accept (the speed
    route carries it)."""
    from cusift_tpu.config import VOConfig

    vo = MonoVO.__new__(MonoVO)          # gate logic needs only vo_cfg
    vo.vo_cfg = VOConfig()

    rng = np.random.default_rng(7)
    n = 40
    frames = list(range(0, 4 * n, 4))
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy()

    def chain(speeds):
        c = np.zeros((n, 3), np.float32)
        c[1:, 0] = np.cumsum(speeds)     # n-1 segment speeds -> n centres
        t = -c
        return t

    def decide(t_raw, t_corr, s_corr=None):
        s_corr = (np.ones(n, np.float32) if s_corr is None
                  else s_corr.astype(np.float32))
        corr = (eye, t_corr * s_corr[:, None], s_corr)
        sig_raw = MonoVO._speed_dispersion(eye, t_raw, None, frames)
        sig_corr = MonoVO._speed_dispersion(*corr, frames)
        sig_delta = MonoVO._correction_roughness(eye, t_raw, corr, frames)
        return vo._gate_accept(sig_raw, sig_corr, sig_delta), (
            sig_raw, sig_corr, sig_delta)

    seg = np.arange(n - 1)

    # 1) healthy: uniform true motion, smooth multiplicative drift; the
    # genuine correction collapses the dispersion -> speed route accepts
    drift = np.exp(np.cumsum(rng.normal(0, 0.06, n - 1)))
    v_true = np.ones(n - 1)
    ok, sigs = decide(chain(v_true * drift), chain(v_true))
    assert ok, sigs

    # 2) poisoned: an x8 modification step over one keyframe segment (the
    # 1000-frame soak's chain-collapse signature) -> both routes reject
    v_raw = np.exp(rng.normal(0, 0.03, n - 1))
    v_bad = v_raw.copy()
    v_bad[n // 2:] *= 8.0
    ok, sigs = decide(chain(v_raw), chain(v_bad))
    assert not ok, sigs

    # 3) stop-and-go false-reject direction: true speed swings ~4x over
    # one slow cycle (genuinely non-uniform, sigma ~0.5); a smooth drift
    # anticorrelates and SMOOTHS the raw profile, so the genuine
    # correction (removing the drift) legitimately RAISES dispersion
    v_true = np.exp(0.7 * np.sin(2 * np.pi * seg / (n - 1)))
    drift = np.exp(-0.65 * np.sin(2 * np.pi * seg / (n - 1))
                   + np.cumsum(rng.normal(0, 0.01, n - 1)))
    ok, sigs = decide(chain(v_true * drift), chain(v_true))
    sig_raw, sig_corr, sig_delta = sigs
    assert sig_corr > sig_raw * vo.vo_cfg.sim3_gate_margin, sigs  # speed route alone WOULD reject
    assert ok, sigs                      # ...but the smoothness route accepts

    # 4) abrupt-but-genuine (blur-burst re-lock): raw has one x6 scale
    # break; the genuine fix is equally abrupt (rough modification) but
    # restores uniform speed -> speed route accepts
    v_broken = np.ones(n - 1)
    v_broken[20:] = 6.0
    ok, sigs = decide(chain(v_broken), chain(np.ones(n - 1)))
    sig_raw, sig_corr, sig_delta = sigs
    assert sig_delta > vo.vo_cfg.sim3_gate_smooth, sigs  # smoothness route alone WOULD reject
    assert ok, sigs
