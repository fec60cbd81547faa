"""Diagnose the 300-frame soak's KITTI segment drift (CPU).

Reproduces tests/test_vo_sequence.py::test_long_loop_sequence_bounded_drift
exactly and prints the full accuracy decomposition: ATE (corrected + raw),
segment drift per subsequence start, the chained-scale history, and the
Sim(3) correction's per-keyframe scales — to locate WHERE the 1/4- and
1/2-path relative translations go wrong.

Run: JAX_PLATFORMS=cpu \
     PYTHONPATH=. python scripts/diag_drift.py
"""

import json

import numpy as np

from cusift_tpu.config import SiftConfig, VOConfig
from cusift_tpu.data.evaluation import (ate_rmse, camera_centers, horn_align,
                                        kitti_drift, trajectory_path_length)
from cusift_tpu.data.synthetic import two_plane_sequence
from cusift_tpu.models.odometry import MonoVO

SIFT = SiftConfig(max_kpts=384, max_kpts_per_octave=256, num_octaves=3)


def seg_drift_detail(est_r, est_t, gt_r, gt_t, lengths, step=2):
    dist = trajectory_path_length(gt_r, gt_t)
    n = len(gt_r)
    est_r = np.asarray(est_r, np.float64)
    est_t = np.asarray(est_t, np.float64)
    gt_r = np.asarray(gt_r, np.float64)
    gt_t = np.asarray(gt_t, np.float64)

    def rel(r, t, i, j):
        rr = r[i] @ r[j].T
        tt = t[i] - rr @ t[j]
        return rr, tt

    rows = []
    for first in range(0, n, step):
        for length in lengths:
            target = dist[first] + length
            j = int(np.searchsorted(dist, target))
            if j >= n:
                continue
            re_, te_ = rel(est_r, est_t, first, j)
            rg_, tg_ = rel(gt_r, gt_t, first, j)
            td = re_.T @ (tg_ - te_)
            # split: how much of the error is segment-length (scale) vs
            # direction?
            mag_e, mag_g = np.linalg.norm(te_), np.linalg.norm(tg_)
            rows.append((first, j, length, np.linalg.norm(td) / length,
                         mag_e / max(mag_g, 1e-9)))
    return rows


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--ba-window", type=int, default=0)
    ap.add_argument("--max-keyframes", type=int, default=96)
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--amplitude", type=float, default=6.0)
    ap.add_argument("--kf-evict", default="redundant")
    ap.add_argument("--huber", type=float, default=0.0)
    ap.add_argument("--kernel", default="huber")
    ap.add_argument("--track-ref", default="prev", choices=("prev", "keyframe"))
    ap.add_argument("--ba-every", type=int, default=2)
    ap.add_argument("--ba-anchor", choices=("newest", "union"),
                    default="newest",
                    help="landmark anchoring scheme (VERDICT r2 task 6)")
    ap.add_argument("--map-anchor", action="store_true",
                    help="persistent-map PnP scale anchoring "
                         "(models/monomap.py) instead of the pair chain")
    ap.add_argument("--map-active-kf", type=int, default=6)
    ap.add_argument("--map-min-inliers", type=int, default=20)
    ap.add_argument("--map-min-obs", type=int, default=4)
    ap.add_argument("--map-min-anchor", type=int, default=24)
    ap.add_argument("--map-gain", type=float, default=0.4)
    ap.add_argument("--sim3-gate", default="speed", choices=("speed", "off"))
    ap.add_argument("--gate-margin", type=float, default=1.15)
    ap.add_argument("--path", default="loop",
                    choices=("loop", "sweep", "forward"))
    ap.add_argument("--near", type=float, default=3.0)
    ap.add_argument("--far", type=float, default=6.0)
    args = ap.parse_args()

    seq = two_plane_sequence(n_frames=args.frames, h=240, w=320, seed=3,
                             motion_scale=0.9, path=args.path,
                             near=args.near, far=args.far,
                             amplitude=args.amplitude)
    vo_cfg = VOConfig(max_keyframes=args.max_keyframes,
                      kf_evict=args.kf_evict, track_ref=args.track_ref,
                      kf_every=4, loop_temporal_gap=30,
                      loop_min_inliers=25, loop_min_score=0.05,
                      loop_min_common=8, map_anchor=args.map_anchor,
                      map_size=4096, map_insert_budget=256,
                      map_active_kf=args.map_active_kf,
                      map_min_inliers=args.map_min_inliers,
                      map_min_obs=args.map_min_obs,
                      map_min_anchor=args.map_min_anchor,
                      map_scale_gain=args.map_gain,
                      sim3_gate=args.sim3_gate,
                      sim3_gate_margin=args.gate_margin)
    from cusift_tpu.config import PoseGraphConfig
    pg_cfg = PoseGraphConfig(huber_delta=args.huber,
                             robust_kernel=args.kernel)
    vo = MonoVO(seq.intr, sift_cfg=SIFT, vo_cfg=vo_cfg, pg_cfg=pg_cfg,
                ba_window=args.ba_window, ba_every=args.ba_every,
                ba_anchor=args.ba_anchor)
    er, et = vo.run(iter(seq.images))

    path = trajectory_path_length(seq.poses_r, seq.poses_t)[-1]
    ate = ate_rmse(er, et, seq.poses_r, seq.poses_t, with_scale=True)
    raw_r, raw_t = np.stack(vo.poses_r), np.stack(vo.poses_t)
    ate_raw = ate_rmse(raw_r, raw_t, seq.poses_r, seq.poses_t,
                       with_scale=True)
    print(json.dumps({
        "n_kf": vo.n_kf, "closures": vo.n_closures,
        "gate_rejects": vo.n_gate_rejects,
        "tracked": sum(1 for s in vo.stats if s["ok"]),
        "pnp_tracked": sum(1 for s in vo.stats if s.get("pnp_ok")),
        "ate": round(float(ate), 4), "ate_raw": round(float(ate_raw), 4),
        "path": round(float(path), 3),
        "ate_pct": round(100 * float(ate) / path, 2),
    }), flush=True)

    for name, (r, t) in (("corrected", (er, et)), ("raw", (raw_r, raw_t))):
        s, _, _ = horn_align(camera_centers(r, t),
                             camera_centers(seq.poses_r, seq.poses_t),
                             with_scale=True)
        ta = (t * s).astype(np.float32)
        t_pc, r_dpm = kitti_drift(r, ta, seq.poses_r, seq.poses_t,
                                  lengths=(0.25 * path, 0.5 * path), step=2)
        print(json.dumps({"traj": name, "horn_scale": round(float(s), 4),
                          "t_pct": round(float(t_pc), 2),
                          "r_dpm": round(float(r_dpm), 4)}), flush=True)
        rows = seg_drift_detail(r, ta, seq.poses_r, seq.poses_t,
                                lengths=(0.25 * path, 0.5 * path), step=10)
        for fr, j, ln, err, smag in rows:
            print(f"  {name} start={fr:3d} end={j:3d} L={ln:6.2f} "
                  f"t_err={100 * err:6.1f}% |t_e|/|t_g|={smag:5.2f}")

    # chained scale history (the mono random walk) + Sim3 node scales.
    # `scale` estimates the physical per-pair |t| in global units, so the
    # honest error signal is its ratio to the TRUE per-pair |t| (up to the
    # one global gauge factor): a flat ratio profile = no scale drift.
    scales = [s["scale"] for s in vo.stats]
    print("scale chain:", " ".join(f"{v:.3f}" for v in scales[::10]))
    gt_step = []
    for i in range(1, len(seq.poses_r)):
        rr = seq.poses_r[i] @ seq.poses_r[i - 1].T
        tt = seq.poses_t[i] - rr @ seq.poses_t[i - 1]
        gt_step.append(np.linalg.norm(tt))
    ratio = np.array(scales) / np.maximum(np.array(gt_step), 1e-9)
    ratio /= np.median(ratio)
    print("scale/|t|_true (gauge-normalised):",
          " ".join(f"{v:.2f}" for v in ratio[::10]))
    if getattr(vo, "_corr", None) is not None:
        cs = vo._corr[2][:vo.n_kf]
        print("sim3 node scales:", " ".join(f"{v:.3f}" for v in cs[::4]))
    for rec in vo.gate_log:
        print("gate:", json.dumps(rec))
    if args.map_anchor:
        # anchor observables: how often the map fired and which way the
        # anchored median pulled relative to the pair chain's estimate
        pulls = [(i, s["map_s_med"] / max(s["scale"], 1e-12),
                  s["map_n_anchor"], s["pnp_ok"])
                 for i, s in enumerate(vo.stats)]
        fired = sum(1 for _, _, _, okk in pulls if okk)
        print(f"anchor fired {fired}/{len(pulls)} frames")
        print("s_med/scale (every 5th):",
              " ".join(f"{i}:{r:.2f}({n})" for i, r, n, okk in pulls[::5]
                       if np.isfinite(r)))


if __name__ == "__main__":
    main()
