"""chip_smoke.py's phases at tiny sizes on the CPU.

The same functions run at full size on the card; here they prove the
control flow, the comparisons and the printed records.  The Pallas
kernel runs in interpret mode.
"""

import json

import numpy as np

import chip_smoke as cs
from cusift_tpu.config import SiftConfig, SlamConfig

TINY = SiftConfig(max_kpts=128, max_kpts_per_octave=64, num_octaves=2,
                  score_dtype="bf16")
SMALL = SiftConfig(max_kpts=384, max_kpts_per_octave=192, num_octaves=3)


def _records(capsys):
    return [json.loads(l) for l in capsys.readouterr().out.splitlines()
            if l.startswith("{")]


def test_throughput_config_is_bench_shape():
    cfg = cs.throughput_config()
    assert cfg.max_kpts == 6144 and cfg.upscale and cfg.score_dtype == "bf16"
    assert [cfg.kpt_budget(o) for o in range(5)] == [3072, 1536, 384, 96, 32]


def test_phase_extract_match_and_matcher(capsys):
    rec = cs.phase_extract_match(h=96, w=128, batch=3, cfg=TINY, iters=2,
                                 interpret=True)
    feats = rec.pop("_feats")
    assert rec["parity"]["unique_overlap"] == 1.0      # CPU against CPU
    assert set(rec["stage_ms"]) == {"pyramid_score", "detect_topk_refine",
                                    "orientation", "descriptor", "match"}
    assert rec["matches_per_pair"] == rec["matches_per_pair_triton"]
    m = cs.phase_matcher(feats.desc, feats.valid, iters=2, interpret=True)
    assert m["idx_agree"] and m["ok_agree_share"] == 1.0
    assert [r["phase"] for r in _records(capsys)] == ["extract_match",
                                                      "matcher"]


def test_parity_counts_unique_positions():
    """Two orientation slots of one keypoint count once, and a keypoint
    the other side lacks lowers the overlap."""
    from cusift_tpu.models.sift import SiftFeatures

    def feats(xs, oris):
        n = len(xs)
        d = np.eye(n, 128, dtype=np.float32)
        return SiftFeatures(x=np.array(xs, np.float32),
                            y=np.zeros(n, np.float32),
                            sigma=np.full(n, 2.0, np.float32),
                            orientation=np.array(oris, np.float32),
                            response=np.ones(n, np.float32),
                            edgeness=np.ones(n, np.float32),
                            octave=np.zeros(n, np.int32), desc=d,
                            valid=np.ones(n, bool))

    b = feats([1.0, 1.0, 9.0], [0.0, 2.0, 0.0])
    assert cs.parity(b, b)["unique_overlap"] == 1.0
    r = cs.parity(feats([1.0, 1.0], [0.0, 2.0]), b)
    assert r["unique_overlap"] == 0.5 and r["median_cosine"] == 1.0


def test_phase_twoview():
    rec = cs.phase_twoview(h=240, w=320, sift_cfg=SiftConfig(
        max_kpts=512, max_kpts_per_octave=256))
    assert rec["corner_err_px"] < 2.0 and rec["inliers"] > 8


def test_phase_slam():
    rec = cs.phase_slam(n_frames=8, h=240, w=320, sift_cfg=SMALL,
                        slam_cfg=SlamConfig(max_keyframes=16,
                                            kf_min_inliers=120,
                                            kf_max_translation=0.12,
                                            kf_max_rotation=0.12,
                                            loop_temporal_gap=3))
    assert rec["tracked"] == rec["frames"] == 8
    assert rec["window_ba_events"] >= 1


def test_phase_other():
    rec = cs.phase_other(n_frames=4, h=240, w=320, sift_cfg=SMALL)
    assert rec["mono_vo"]["frames"] == 4 and rec["stereo"]["frames"] == 4
    assert rec["sfm"]["tracks"] > 0


def test_phase_multichip():
    """Four of the suite's eight virtual devices stand in for four cards."""
    from cusift_tpu.config import BAConfig

    rec = cs.phase_multichip(n_dev=4, n_cams=6, n_pts=64, h=64, w=96,
                             batch=4, cfg=TINY,
                             ba_cfg=BAConfig(max_iters=4, cg_iters=20,
                                             num_fixed_poses=2))
    assert rec["extract"]["valid_sharded"] == rec["extract"]["valid_one_card"]
    assert rec["ba"]["final_cost_rel_diff"] <= 1e-3
