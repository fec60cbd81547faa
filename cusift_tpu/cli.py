"""Command-line tools (reference analog: the mainSift.cpp demo, SURVEY.md C16).

    python -m cusift_tpu.cli demo [--image-a A --image-b B]
    python -m cusift_tpu.cli slam [--tum DIR | --synthetic N] [--metrics out.jsonl]
    python -m cusift_tpu.cli sfm  [--synthetic N]

Runs on whatever backend JAX selects (the GPU when one is present) and
prints the platform and device kind first.  With no input paths,
ground-truth synthetic scenes are used so every command works in a
dataset-less environment.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _load_image(path: str) -> np.ndarray:
    from .utils.image import to_gray_float
    from .utils import native_loader
    if path.endswith((".pgm", ".ppm", ".npy")) and native_loader.native_available():
        return native_loader.decode(path)
    from .utils.image import import_cv2
    cv2 = import_cv2(f"reading {path} (.pgm/.ppm/.npy use the native loader)")
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    return to_gray_float(img)


def cmd_demo(args):
    import jax.numpy as jnp
    from .config import MatchConfig, RansacConfig, SiftConfig
    from .models.twoview import match_pair
    from .data.synthetic import warped_pair
    from .utils.image import pad_to_tier

    if args.image_a and args.image_b:
        img_a = _load_image(args.image_a)
        img_b = _load_image(args.image_b)
        # canonical shape tiers: arbitrary input sizes share one compiled
        # program per tier (SURVEY.md §7 hard part #5); features landing in
        # the zero-pad apron are masked out below
        (img_a, (ha, wa)) = pad_to_tier(img_a)
        (img_b, (hb, wb)) = pad_to_tier(img_b)
    else:
        print("no images given; using a synthetic ground-truth warped pair")
        img_a, img_b, _ = warped_pair(480, 640, seed=1, blobs=1200)
        (ha, wa), (hb, wb) = img_a.shape, img_b.shape

    t0 = time.time()
    sift_cfg = SiftConfig(max_kpts=args.max_kpts,
                          max_kpts_per_octave=args.max_kpts // 2)
    res = match_pair(jnp.asarray(img_a), jnp.asarray(img_b),
                     sift_cfg, MatchConfig(), RansacConfig(),
                     content_a=(ha, wa), content_b=(hb, wb))
    h = np.asarray(res.homography.h)
    print(f"features A: {int(res.feats_a.count)}   B: {int(res.feats_b.count)}")
    print(f"matches: {int(np.asarray(res.matches.ok).sum())}   "
          f"inliers: {int(res.homography.num_inliers)}   "
          f"({time.time() - t0:.1f}s incl. compile)")
    print("homography:")
    print(np.array2string(h, precision=4, suppress_small=True))
    if args.viz:
        from .utils.viz import draw_keypoints, draw_matches
        draw_keypoints(img_a, res.feats_a, f"{args.viz}_kpts_a.png")
        draw_keypoints(img_b, res.feats_b, f"{args.viz}_kpts_b.png")
        draw_matches(img_a, res.feats_a, img_b, res.feats_b, res.matches,
                     inliers=np.asarray(res.homography.inliers),
                     path=f"{args.viz}_matches.png")
        print(f"overlays written to {args.viz}_*.png")


def cmd_slam(args):
    import jax
    from .config import RansacConfig, SiftConfig, SlamConfig
    from .models.slam import Slam
    from .utils.logging import JsonlWriter
    from .data import tum as tum_mod
    from .data.evaluation import rpe
    from .data.synthetic import planar_rgbd_sequence

    writer = JsonlWriter(args.metrics) if args.metrics else None
    timestamps: list[float] = []
    if args.tum:
        if not tum_mod.available(args.tum):
            sys.exit(f"TUM sequence not found at {args.tum}")
        intr = tum_mod.intrinsics_for(args.tum)
        frames = tum_mod.load_tum(args.tum, max_frames=args.frames or None)
        seq = None
    else:
        n = args.synthetic or 12
        seq = planar_rgbd_sequence(n_frames=n, h=480, w=640, seed=0,
                                   motion_scale=0.8)
        intr = seq.intr
        timestamps = list(seq.timestamps)
        frames = ((seq.images[i], seq.depths[i]) for i in range(n))

    slam = Slam(intr,
                sift_cfg=SiftConfig(max_kpts=args.max_kpts,
                                    max_kpts_per_octave=args.max_kpts // 2),
                ransac_cfg=RansacConfig(inlier_thresh_3d=0.03),
                slam_cfg=SlamConfig(checkpoint_every=args.checkpoint_every,
                                    local_ba_anchor=args.ba_anchor,
                                    kf_evict=args.kf_evict),
                dist_ba=getattr(args, "dist", False))
    t0 = time.time()

    def as_pairs(items):
        for item in items:
            if hasattr(item, "image"):
                timestamps.append(item.timestamp)
                yield (item.image, item.depth)
            else:
                yield item

    def on_metric(rec):      # streamed, so interrupted runs keep metrics
        if writer:
            writer.write(rec)
        if (rec["frame"] + 1) % 10 == 0:
            print(f"frame {rec['frame'] + 1}: kpts={rec['kpts']} "
                  f"inliers={rec['inliers']} kf={slam.state.n_kf} "
                  f"loops={slam.state.n_closures}")

    slam.on_metric = on_metric
    slam.run(as_pairs(frames))   # pipelined uploads (utils/pipeline.py)
    n_frames = len(slam.metrics)
    dt = time.time() - t0
    print(f"processed {n_frames} frames in {dt:.1f}s "
          f"({n_frames / dt:.2f} frames/s incl. compile); "
          f"{slam.state.n_kf} keyframes, {slam.state.n_closures} closures")
    if seq is not None:
        ate = slam.ate(seq.poses_r, seq.poses_t)
        est_r, est_t = slam.trajectory()
        t_rpe, r_rpe = rpe(est_r, est_t, seq.poses_r, seq.poses_t)
        print(f"ATE RMSE {ate:.4f} m   RPE {t_rpe:.4f} m / {r_rpe:.4f} rad")
    if args.save:
        slam.checkpoint(args.save)
        print(f"state saved to {args.save}")
    if args.save_trajectory:
        from .utils.viz import save_trajectory_tum
        est_r, est_t = slam.trajectory()
        ts = timestamps if len(timestamps) == len(est_r) \
            else np.arange(len(est_r), dtype=np.float64)
        save_trajectory_tum(args.save_trajectory, ts, est_r, est_t)
        print(f"trajectory ({len(est_r)} poses, TUM format) "
              f"written to {args.save_trajectory}")


def cmd_stereo(args):
    """Stereo SLAM (BASELINE configs[4] geometry: KITTI supplies stereo).

    Rectified pairs give METRIC per-feature depth (ops/stereo.py), so the
    full RGB-D backend runs at true scale — no Sim(3) layer, no scale
    alignment in the metrics.
    """
    from .config import RansacConfig, SiftConfig, SlamConfig
    from .data import kitti as kitti_mod
    from .data.evaluation import ate_rmse, kitti_drift
    from .data.synthetic import two_plane_stereo_sequence
    from .models.stereo import StereoSlam

    gt = None
    if args.kitti:
        if not kitti_mod.stereo_available(args.kitti):
            sys.exit(f"KITTI stereo pair not found at {args.kitti}")
        intr = kitti_mod.load_calib(args.kitti)
        baseline = args.baseline or kitti_mod.load_baseline(args.kitti)
        frames = kitti_mod.load_stereo(args.kitti,
                                       max_frames=args.frames or None)
        if args.poses:
            poses = kitti_mod.load_poses(args.poses)
            gt = (np.stack([p[0] for p in poses]),
                  np.stack([p[1] for p in poses]))
    else:
        n = args.synthetic or 8
        print("no dataset given; using a synthetic stereo two-plane scene")
        seq = two_plane_stereo_sequence(n_frames=n, h=240, w=320, seed=0,
                                        motion_scale=0.7, amplitude=2.0)
        intr = seq.intr
        baseline = args.baseline or seq.baseline
        frames = zip(seq.images_l, seq.images_r)
        gt = (seq.poses_r, seq.poses_t)

    slam = StereoSlam(
        intr, baseline,
        sift_cfg=SiftConfig(max_kpts=args.max_kpts,
                            max_kpts_per_octave=args.max_kpts // 2),
        ransac_cfg=RansacConfig(inlier_thresh_3d=0.05),
        slam_cfg=SlamConfig(kf_evict=args.kf_evict))
    t0 = time.time()
    recs = slam.run(frames, max_frames=args.frames or None)
    dt = time.time() - t0
    est_r, est_t = slam.trajectory()
    print(f"processed {len(recs)} frames in {dt:.1f}s "
          f"({len(recs) / dt:.2f} frames/s incl. compile); "
          f"{slam.state.n_kf} keyframes, {slam.state.n_closures} closures, "
          f"baseline {baseline:.3f} m")
    if gt is not None:
        n_f = len(est_r)
        gt_r, gt_t = gt[0][:n_f], gt[1][:n_f]
        ate = ate_rmse(est_r, est_t, gt_r, gt_t)   # METRIC: no scale fit
        print(f"metric ATE RMSE {ate:.4f} m")
        t_pc, r_pc = kitti_drift(est_r, est_t, gt_r, gt_t)
        if np.isfinite(t_pc):
            print(f"KITTI drift: {t_pc:.2f} % translation, "
                  f"{r_pc:.4f} deg/m rotation")
    if args.save_trajectory:
        np.savetxt(args.save_trajectory, np.concatenate(
            [np.asarray(est_r).reshape(len(est_r), 9),
             np.asarray(est_t)], -1))
        print(f"trajectory written to {args.save_trajectory}")


def cmd_sfm(args):
    from .config import BAConfig, RansacConfig, SiftConfig
    from .data.evaluation import ate_rmse
    from .data.synthetic import planar_rgbd_sequence
    from .models.sfm import reconstruct_rgbd

    n = args.synthetic or 8
    seq = planar_rgbd_sequence(n_frames=n, h=480, w=640, seed=0, motion_scale=0.6)
    t0 = time.time()
    rec = reconstruct_rgbd(seq.images, seq.depths, seq.intr,
                           sift_cfg=SiftConfig(max_kpts=args.max_kpts,
                                               max_kpts_per_octave=args.max_kpts // 2),
                           ransac_cfg=RansacConfig(inlier_thresh_3d=0.03),
                           ba_cfg=BAConfig(huber_delta=4.0, num_fixed_poses=2))
    print(f"{rec.n_tracks} tracks, {rec.n_obs} observations "
          f"({time.time() - t0:.1f}s incl. compile)")
    print(f"BA cost {float(rec.ba.initial_cost):.1f} -> {float(rec.ba.cost):.1f} "
          f"in {int(rec.ba.iterations)} accepted steps")
    print(f"ATE RMSE vs ground truth: "
          f"{ate_rmse(rec.poses_r, rec.poses_t, seq.poses_r, seq.poses_t):.4f} m")


def cmd_odo(args):
    """Monocular visual odometry (BASELINE configs[4] frontend).

    --kitti SEQ_DIR runs a real KITTI odometry sequence (optionally with
    --poses for ground-truth drift metrics); with no dataset a synthetic
    two-plane scene exercises the identical pipeline.
    """
    from .config import RansacConfig, SiftConfig
    from .data import kitti as kitti_mod
    from .data.evaluation import ate_rmse, kitti_drift
    from .data.synthetic import two_plane_sequence
    from .models.odometry import MonoVO

    gt = None
    if args.kitti:
        if not kitti_mod.available(args.kitti):
            sys.exit(f"KITTI sequence not found at {args.kitti}")
        intr = kitti_mod.load_calib(args.kitti)
        frames = kitti_mod.load_images(args.kitti,
                                       max_frames=args.frames or None)
        if args.poses:
            poses = kitti_mod.load_poses(args.poses)
            gt = (np.stack([p[0] for p in poses]),
                  np.stack([p[1] for p in poses]))
    else:
        n = args.synthetic or 8
        print("no dataset given; using a synthetic two-plane scene")
        seq = two_plane_sequence(n_frames=n, h=480, w=640, seed=0)
        intr = seq.intr
        frames = iter(seq.images)
        gt = (seq.poses_r, seq.poses_t)

    from .config import VOConfig
    vo_cfg = (VOConfig(map_anchor=args.map_anchor, kf_evict=args.kf_evict,
                       sim3_gate=args.sim3_gate)
              if (args.loop or args.map_anchor) else None)
    vo = MonoVO(intr,
                sift_cfg=SiftConfig(max_kpts=args.max_kpts,
                                    max_kpts_per_octave=args.max_kpts // 2),
                ransac_cfg=RansacConfig(),
                ba_window=args.ba_window,
                ba_anchor=args.ba_anchor,
                pad_to_tier=args.tier_pad,
                vo_cfg=vo_cfg, dist_ba=args.dist)
    if args.resume:
        vo.restore(args.resume)
        print(f"resumed from {args.resume} "
              f"({len(vo.poses_r)} frames already tracked)")
    t0 = time.time()
    est_r, est_t = vo.run(frames, max_frames=args.frames or None)
    dt = time.time() - t0
    if args.save:     # outside the timing window: npz compression is I/O
        vo.checkpoint(args.save)
        print(f"state checkpointed to {args.save}")
    n_frames = len(est_r)
    ok = sum(1 for s in vo.stats if s["ok"])
    extra = (f"; {vo.n_kf} keyframes, {vo.n_closures} loop closures"
             if args.loop else "")
    if args.dist and vo._ba_mesh is not None:
        extra += f"; BA sharded over {vo._ba_mesh.devices.size} devices"
    print(f"processed {n_frames} frames in {dt:.1f}s "
          f"({n_frames / dt:.2f} frames/s incl. compile); "
          f"{ok}/{len(vo.stats)} pairs tracked{extra}")
    if gt is not None and n_frames > len(gt[0]):
        # a resumed run's trajectory spans more frames than the ground
        # truth fed this invocation; a frame-aligned comparison would lie
        print(f"skipping gt metrics: {n_frames} estimated frames vs "
              f"{len(gt[0])} ground-truth poses (resumed run?)")
        gt = None
    if gt is not None:
        from .data.evaluation import camera_centers, horn_align, \
            trajectory_path_length
        gt_r, gt_t = gt[0][:n_frames], gt[1][:n_frames]
        ate = ate_rmse(est_r, est_t, gt_r, gt_t, with_scale=True)
        # the monocular trajectory's global scale is arbitrary (anchored at
        # |t|=1 on the first pair): apply the Umeyama scale to the estimate
        # before the drift metric so the printed translation-% measures
        # drift, not the unobservable global scale offset
        s, _, _ = horn_align(camera_centers(est_r, est_t),
                             camera_centers(gt_r, gt_t), with_scale=True)
        est_t = (est_t * s).astype(np.float32)
        t_pc, r_dpm = kitti_drift(est_r, est_t, gt_r, gt_t)
        if np.isnan(t_pc):
            # sequence shorter than the standard 100..800 m evaluation
            # lengths: fall back to fractions of the actual path
            total = trajectory_path_length(gt_r, gt_t)[-1]
            if total > 0:
                t_pc, r_dpm = kitti_drift(
                    est_r, est_t, gt_r, gt_t,
                    lengths=(0.25 * total, 0.5 * total), step=1)
        print(f"ATE RMSE (Sim3-aligned) {ate:.4f} m")
        print(f"KITTI drift: {t_pc:.2f} % translation, "
              f"{r_dpm:.4f} deg/m rotation")
    if args.save_trajectory:
        from .utils.viz import save_trajectory_tum
        save_trajectory_tum(args.save_trajectory,
                            np.arange(n_frames, dtype=np.float64),
                            est_r, est_t)
        print(f"trajectory written to {args.save_trajectory}")


def cmd_dist(args):
    """Multi-device pipeline: sharded extraction + distributed Schur BA.

    Exercises BASELINE configs[4]'s machinery on whatever devices exist —
    the GPUs of one host, or a virtual CPU mesh via
    XLA_FLAGS=--xla_force_host_platform_device_count=N (SURVEY.md §4.4).
    Prints per-device-count timings so scaling efficiency is visible.
    """
    import jax
    import jax.numpy as jnp
    from .config import BAConfig, SiftConfig
    from .data.synthetic import ba_problem, textured_image
    from .parallel.dist_ba import distributed_bundle_adjust, partition_by_landmark
    from .parallel.mesh import make_mesh, map_mesh
    from .parallel.sharded import extract_frames

    devs = jax.devices()
    counts = [n for n in (1, 2, 4, 8, 16) if n <= len(devs)]
    print(f"{len(devs)} device(s): {devs[0].platform}")
    cfg = SiftConfig(max_kpts=args.max_kpts,
                     max_kpts_per_octave=args.max_kpts // 2,
                     num_octaves=3)
    h, w = 240, 320
    for n in counts:
        mesh = make_mesh(frames=n, map_=1, devices=devs[:n])
        imgs = jnp.asarray(np.stack(
            [textured_image(h, w, seed=s, blobs=120) for s in range(n * 2)]))
        t0 = time.time()
        feats = extract_frames(imgs, mesh, cfg)
        total = int(np.asarray(feats.valid.sum()))
        dt = time.time() - t0
        print(f"  extract {n * 2} frames on {n} dev: {dt:.2f}s "
              f"(incl. compile), {total} kpts")
    for n in counts:
        d, _ = ba_problem(seed=0, n_cams=8, n_pts=64 * n, pixel_noise=0.4)
        parts = partition_by_landmark(d, n)
        bmesh = map_mesh(n, devices=devs[:n])
        t0 = time.time()
        res = distributed_bundle_adjust(parts, bmesh,
                                        BAConfig(max_iters=5, cg_iters=15,
                                                 num_fixed_poses=2))
        c0, c1 = float(res.initial_cost), float(res.cost)
        print(f"  dist-BA {64 * n} landmarks on {n} dev: "
              f"{time.time() - t0:.2f}s, cost {c0:.1f} -> {c1:.1f}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cusift_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("demo", help="two-view extract+match+homography")
    d.add_argument("--image-a")
    d.add_argument("--image-b")
    d.add_argument("--max-kpts", type=int, default=2048)
    d.add_argument("--viz", help="write keypoint/match overlay PNGs "
                                 "with this path prefix")
    d.set_defaults(fn=cmd_demo)

    s = sub.add_parser("slam", help="RGB-D SLAM over a sequence")
    s.add_argument("--tum", help="TUM sequence directory")
    s.add_argument("--synthetic", type=int, help="use N synthetic frames")
    s.add_argument("--frames", type=int, default=0)
    s.add_argument("--max-kpts", type=int, default=1024)
    s.add_argument("--metrics", help="JSONL metrics output path")
    s.add_argument("--save", help="checkpoint output path")
    s.add_argument("--checkpoint-every", type=int, default=0)
    s.add_argument("--ba-anchor", choices=("newest", "union"),
                   default="newest",
                   help="local-BA landmark anchoring scheme (union "
                        "forces the single-device BA path)")
    s.add_argument("--kf-evict", choices=("redundant", "oldest", "none"),
                   default="redundant",
                   help="keyframe eviction policy once the ring is full "
                        "(redundant keeps spatial coverage; none restores "
                        "the stop-growing behaviour)")
    s.add_argument("--dist", action="store_true",
                   help="shard the local-BA Schur solve over every "
                        "device's map axis (needs >1 devices)")
    s.add_argument("--save-trajectory",
                   help="write the per-frame trajectory in TUM format")
    s.set_defaults(fn=cmd_slam)

    o = sub.add_parser("odo", help="monocular visual odometry "
                                   "(KITTI; BASELINE configs[4] frontend)")
    o.add_argument("--kitti", help="KITTI sequence directory "
                                   "(sequences/NN)")
    o.add_argument("--poses", help="KITTI ground-truth pose file "
                                   "(poses/NN.txt)")
    o.add_argument("--synthetic", type=int, help="use N synthetic frames")
    o.add_argument("--frames", type=int, default=0)
    o.add_argument("--max-kpts", type=int, default=1024)
    o.add_argument("--ba-anchor", choices=("newest", "union"),
                   default="newest",
                   help="windowed-BA landmark anchoring scheme (union "
                        "forces the single-device BA path)")
    o.add_argument("--ba-window", type=int, default=0,
                   help="bundle-adjust the last N frames as they stream "
                        "(0 = off)")
    o.add_argument("--loop", action="store_true",
                   help="sequence-scale frontend: keyframe ring + loop "
                        "closure + Sim(3) pose graph (bounds long-run "
                        "drift)")
    o.add_argument("--map-anchor", action="store_true",
                   help="persistent-landmark map + PnP localisation "
                        "(anchors the monocular scale to the map instead "
                        "of the per-pair chain; implies --loop)")
    o.add_argument("--kf-evict", choices=("redundant", "oldest", "none"),
                   default="redundant",
                   help="keyframe eviction policy once the ring is full")
    o.add_argument("--sim3-gate", choices=("speed", "off"), default="speed",
                   help="health gate on each Sim(3) correction solve: "
                        "reject solves whose keyframe speed profile gets "
                        "less uniform than the raw chain's (poisoned loop "
                        "scale observables); rejected solves keep the "
                        "last accepted correction")
    o.add_argument("--save", help="checkpoint VO state to this npz at end")
    o.add_argument("--resume", help="restore VO state from this npz first")
    o.add_argument("--dist", action="store_true",
                   help="shard the windowed-BA Schur solve over every "
                        "device's map axis (needs --ba-window and >1 "
                        "devices)")
    o.add_argument("--tier-pad", action="store_true",
                   help="pad frames to canonical shape tiers so mixed "
                        "resolutions share compiled programs")
    o.add_argument("--save-trajectory")
    o.set_defaults(fn=cmd_odo)

    st = sub.add_parser("stereo", help="stereo SLAM/odometry "
                        "(rectified pairs; metric scale)")
    st.add_argument("--kitti", help="KITTI sequence directory "
                    "(needs image_0 + image_1)")
    st.add_argument("--poses", help="KITTI ground-truth pose file")
    st.add_argument("--synthetic", type=int, help="use N synthetic frames")
    st.add_argument("--frames", type=int, default=0)
    st.add_argument("--max-kpts", type=int, default=1024)
    st.add_argument("--baseline", type=float, default=0.0,
                    help="rig baseline in metres (read from KITTI calib "
                         "P1 when --kitti is given)")
    st.add_argument("--kf-evict", choices=("redundant", "oldest", "none"),
                    default="redundant")
    st.add_argument("--save-trajectory")
    st.set_defaults(fn=cmd_stereo)

    f = sub.add_parser("sfm", help="small incremental SfM + BA")
    f.add_argument("--synthetic", type=int)
    f.add_argument("--max-kpts", type=int, default=1024)
    f.set_defaults(fn=cmd_sfm)

    g = sub.add_parser("dist", help="multi-device sharded extract + Schur BA")
    g.add_argument("--max-kpts", type=int, default=256)
    g.set_defaults(fn=cmd_dist)

    args = ap.parse_args(argv)
    from .parallel.mesh import init_distributed
    from .utils.device import device_info, enable_compile_cache
    # multi-host bootstrap (no-op without JAX_COORDINATOR_ADDRESS) must
    # precede the first backend query
    init_distributed()
    enable_compile_cache()
    info = device_info()
    print(f"device: {info['platform']} {info['kind']} x{info['count']}")
    args.fn(args)


if __name__ == "__main__":
    main()
