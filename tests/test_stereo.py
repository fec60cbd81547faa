"""Stereo frontend: rectified feature depth + metric-scale SLAM.

The stereo rig removes the monocular scale ambiguity: depth is measured
per feature as fx*b/disparity (ops/stereo.py) and the unchanged RGB-D
backend (models/slam.py) tracks at METRIC scale — so unlike every mono
test, ATE here is asserted WITHOUT Sim(3)/scale alignment.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cusift_tpu.config import MatchConfig, SiftConfig, SlamConfig
from cusift_tpu.data.evaluation import ate_rmse
from cusift_tpu.data.synthetic import two_plane_stereo_sequence
from cusift_tpu.models.sift import extract
from cusift_tpu.models.stereo import StereoSlam, _extract_stereo_points
from cusift_tpu.ops.stereo import stereo_depth

SIFT = SiftConfig(max_kpts=384, max_kpts_per_octave=256, num_octaves=3)


@pytest.fixture(scope="module")
def seq():
    return two_plane_stereo_sequence(n_frames=10, h=240, w=320, seed=4,
                                     motion_scale=0.7, amplitude=2.0,
                                     baseline=0.12)


def test_stereo_depth_matches_analytic(seq):
    """Feature disparities recover the analytic plane depths."""
    fl = extract(jnp.asarray(seq.images_l[0]), SIFT)
    fr = extract(jnp.asarray(seq.images_r[0]), SIFT)
    fx = float(seq.intr[0])
    depth, ok = stereo_depth(fl.desc, fl.valid, fl.x, fl.y,
                             fr.desc, fr.valid, fr.x, fr.y,
                             fx, seq.baseline, MatchConfig())
    ok = np.asarray(ok)
    # the small dim render yields ~120 valid left features; ~86 stereo-match
    assert ok.sum() >= 60, f"only {ok.sum()} stereo matches"
    xi = np.clip(np.round(np.asarray(fl.x)).astype(int), 0, 319)
    yi = np.clip(np.round(np.asarray(fl.y)).astype(int), 0, 239)
    gt = seq.depths[0][yi, xi]
    have = ok & (gt > 0.05)
    rel = np.abs(np.asarray(depth)[have] - gt[have]) / gt[have]
    assert np.median(rel) < 0.02, np.median(rel)
    # the batched-extraction wrapper's backprojections also match the
    # analytic depths at its own feature pixels (its feature SET may
    # differ at float margins from single-image extraction — vmapped
    # convs tile differently — so no cross-path elementwise comparison)
    fl2, pts, dok = _extract_stereo_points(
        jnp.asarray(seq.images_l[0]), jnp.asarray(seq.images_r[0]),
        jnp.asarray(seq.intr), jnp.float32(seq.baseline), SIFT,
        MatchConfig())
    dok = np.asarray(dok)
    assert dok.sum() >= 60
    xi2 = np.clip(np.round(np.asarray(fl2.x)).astype(int), 0, 319)
    yi2 = np.clip(np.round(np.asarray(fl2.y)).astype(int), 0, 239)
    gt2 = seq.depths[0][yi2, xi2]
    have2 = dok & (gt2 > 0.05)
    z = np.asarray(pts)[:, 2]
    rel2 = np.abs(z[have2] - gt2[have2]) / gt2[have2]
    assert np.median(rel2) < 0.02, np.median(rel2)


@pytest.mark.slow
def test_stereo_slam_tracks_metric_scale(seq):
    """End-to-end stereo SLAM: ATE bound WITHOUT any scale alignment."""
    slam = StereoSlam(seq.intr, seq.baseline, sift_cfg=SIFT,
                      slam_cfg=SlamConfig(max_keyframes=16,
                                          loop_temporal_gap=50))
    recs = slam.run(zip(seq.images_l, seq.images_r))
    assert len(recs) == 10
    assert sum(r.get("tracked", True) for r in recs) == 10
    # metric scale: no with_scale — stereo pins the unit
    ate = ate_rmse(*slam.trajectory(), seq.poses_r, seq.poses_t)
    assert ate < 0.05, f"metric ATE {ate:.4f} m"
    # and the recovered trajectory length matches ground truth within 5%
    est_r, est_t = slam.trajectory()
    c_est = -np.einsum("nij,ni->nj", est_r, est_t)
    c_gt = -np.einsum("nij,ni->nj", seq.poses_r, seq.poses_t)
    len_est = np.linalg.norm(np.diff(c_est, axis=0), axis=-1).sum()
    len_gt = np.linalg.norm(np.diff(c_gt, axis=0), axis=-1).sum()
    assert abs(len_est / len_gt - 1.0) < 0.05, (len_est, len_gt)


@pytest.mark.slow
def test_stereo_loop_soak_metric_drift():
    """150-frame stereo circuit: metric drift far below the mono chain.

    Same world/trajectory as the mono soak (two-plane loop): the mono
    scale chain measures 37.6% KITTI translation drift after scale
    alignment (62f0428:BASELINE.md); stereo's per-feature metric depth holds
    ~10% WITHOUT any alignment, through ring eviction (24 slots for ~
    40+ promotions) and loop closure.  dist_ba=True runs every windowed
    BA solve landmark-sharded over the virtual 8-device mesh — the full
    configs[4] combination (streaming dist-BA x eviction x closures) at
    soak length (VERDICT r3 task 4; the 4,541-frame single-device run
    lives in 62f0428:BASELINE.md round 4).
    """
    from cusift_tpu.data.evaluation import kitti_drift, \
        trajectory_path_length

    seq = two_plane_stereo_sequence(n_frames=150, h=240, w=320, seed=3,
                                    motion_scale=0.9, path="loop",
                                    amplitude=6.0)
    slam = StereoSlam(seq.intr, seq.baseline, sift_cfg=SIFT,
                      slam_cfg=SlamConfig(max_keyframes=24,
                                          loop_temporal_gap=8),
                      dist_ba=True)
    assert slam._ba_mesh is not None
    recs = slam.run(zip(seq.images_l, seq.images_r))
    assert sum(r.get("tracked", True) for r in recs) >= 145
    assert slam.state.n_kf == 24      # ring at capacity, still inserting
    er, et = slam.trajectory()
    path = trajectory_path_length(seq.poses_r, seq.poses_t)[-1]
    ate = ate_rmse(er, et, seq.poses_r, seq.poses_t)     # metric
    assert ate < 0.04 * path, (ate, path)
    t_pc, _ = kitti_drift(er, et, seq.poses_r, seq.poses_t,
                          lengths=(0.25 * path, 0.5 * path), step=2)
    assert np.isfinite(t_pc) and t_pc < 15.0, t_pc


def test_stereo_chunked_run_matches_sequential(seq):
    """chunk>1 stereo tracking stays geometrically consistent (same ATE).

    The stereo mirror of test_slam.py::test_chunked_run_matches_sequential
    — round-3's stereo path raised on chunk>1 (VERDICT r3 task 4); the
    chunked dispatch now rides the shared _chunk_sense_step hook.
    """
    def build():
        return StereoSlam(seq.intr, seq.baseline, sift_cfg=SIFT,
                          slam_cfg=SlamConfig(max_keyframes=16,
                                              loop_temporal_gap=50))

    s1 = build()
    s1.run(zip(seq.images_l, seq.images_r), chunk=1)
    s3 = build()
    s3.run(zip(seq.images_l, seq.images_r), chunk=3)
    assert len(s3.metrics) == 10
    assert sum(r.get("tracked", True) for r in s3.metrics) == 10
    # metric ATE (no scale alignment) for both dispatch shapes
    ate1 = ate_rmse(*s1.trajectory(), seq.poses_r, seq.poses_t)
    ate3 = ate_rmse(*s3.trajectory(), seq.poses_r, seq.poses_t)
    assert ate1 < 0.05 and ate3 < 0.05, (ate1, ate3)


def test_stereo_slam_distributed_window_ba():
    """StereoSlam(dist_ba=True) runs the landmark-sharded window BA on
    the virtual device mesh (the configs[4] streaming form, inherited
    unchanged from the RGB-D backend)."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs the multi-device CPU mesh")
    seq = two_plane_stereo_sequence(n_frames=8, h=192, w=256, seed=6,
                                    motion_scale=0.7, amplitude=2.0)
    sift = SiftConfig(max_kpts=256, max_kpts_per_octave=192, num_octaves=3)
    slam = StereoSlam(seq.intr, seq.baseline, sift_cfg=sift,
                      slam_cfg=SlamConfig(max_keyframes=12,
                                          kf_min_inliers=200,
                                          local_ba_window=3,
                                          loop_temporal_gap=50),
                      dist_ba=True)
    assert slam._ba_mesh is not None
    recs = slam.run(zip(seq.images_l, seq.images_r))
    assert sum(r.get("tracked", True) for r in recs) >= 7
    ate = ate_rmse(*slam.trajectory(), seq.poses_r, seq.poses_t)
    assert ate < 0.06, f"metric ATE {ate:.4f} m"
