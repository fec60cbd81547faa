"""Probe: long RGB-D SLAM soak (configs[3] scale realism).

Measures what a sequence-scale run of models/slam.py actually does on a
150-frame closed-circuit planar scene with sensor-like depth noise and a
keyframe ring DELIBERATELY smaller than the run needs — the behaviours a
soak test must assert: tracking survival at ring capacity, loop-closure
count, ATE bound.  CPU-runnable (conftest-free: force the CPU platform).

  JAX_PLATFORMS=cpu PYTHONPATH=. \
      python scripts/slam_soak_probe.py --frames 150
"""

import argparse
import time

import jax
jax.config.update("jax_platforms", "cpu")

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--size", type=int, nargs=2, default=(240, 320))
    ap.add_argument("--max-keyframes", type=int, default=20)
    ap.add_argument("--depth-noise", type=float, default=0.01)
    ap.add_argument("--max-kpts", type=int, default=256)
    ap.add_argument("--ba-window", type=int, default=0)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--loop-gap", type=int, default=8)
    ap.add_argument("--motion", type=float, default=1.0)
    ap.add_argument("--evict", default="redundant")
    args = ap.parse_args()

    from cusift_tpu.config import SiftConfig, SlamConfig
    from cusift_tpu.data.synthetic import planar_rgbd_sequence
    from cusift_tpu.models.slam import Slam

    h, w = args.size
    seq = planar_rgbd_sequence(n_frames=args.frames, h=h, w=w,
                               seed=args.seed, motion_scale=args.motion,
                               depth_noise=args.depth_noise)
    sift = SiftConfig(max_kpts=args.max_kpts,
                      max_kpts_per_octave=args.max_kpts,
                      num_octaves=3, upscale=False)
    slam_cfg = SlamConfig(max_keyframes=args.max_keyframes,
                          local_ba_window=args.ba_window,
                          loop_temporal_gap=args.loop_gap,
                          kf_evict=args.evict,
                          checkpoint_every=0)
    slam = Slam(seq.intr, sift_cfg=sift, slam_cfg=slam_cfg)
    t0 = time.perf_counter()
    recs = slam.run(zip(seq.images, seq.depths))
    dt = time.perf_counter() - t0

    tracked = [r.get("tracked", True) for r in recs]
    kfs = [r["frame"] for r in recs if r.get("keyframe")]
    loops = [r["frame"] for r in recs if r.get("loop")]
    n_kf = slam.state.n_kf
    # the bootstrap keyframe is recs[0], so the ring is full at the
    # max_keyframes-th keyframe record
    full_at = (kfs[args.max_keyframes - 1]
               if len(kfs) >= args.max_keyframes else None)
    after_full = [r for r in recs if full_at is not None and r["frame"] > full_at]
    ate = slam.ate(seq.poses_r, seq.poses_t)
    path = np.linalg.norm(np.diff(
        -np.einsum("nij,ni->nj", seq.poses_r, seq.poses_t), axis=0),
        axis=-1).sum()
    print(f"frames={args.frames} wall={dt:.1f}s ({dt/args.frames*1e3:.0f} "
          f"ms/frame) kf={n_kf}/{args.max_keyframes} "
          f"kf_frames={kfs[:8]}...{kfs[-3:] if len(kfs) > 8 else ''}")
    print(f"tracked={sum(tracked)}/{len(tracked)} "
          f"tracked_after_ring_full={sum(r.get('tracked', True) for r in after_full)}"
          f"/{len(after_full)} loops={len(loops)} at {loops[:10]}")
    print(f"ATE={ate:.4f} m  path={path:.3f} m  ate/path={ate/path*100:.2f}%")


if __name__ == "__main__":
    main()
