"""Wall-clock decomposition of the streaming SLAM loop.

Times the loop's host-visible segments (chunk dispatch, packed fetch,
keyframe ring insert, windowed BA, loop-closure retrieve+verify,
pose-graph solve) to locate where a frame's time goes before optimising
anything.

Run: PYTHONPATH=. python scripts/loop_profile.py
"""

import json
import time
from collections import defaultdict

import jax

from cusift_tpu.utils.device import enable_compile_cache
enable_compile_cache()
import numpy as np

import cusift_tpu.models.slam as mslam
from cusift_tpu.config import SiftConfig, SlamConfig
from cusift_tpu.data.synthetic import two_plane_stereo_sequence
from cusift_tpu.models.stereo import StereoSlam

TIMES = defaultdict(float)
COUNTS = defaultdict(int)


def timed(name, fn):
    def wrap(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        TIMES[name] += time.perf_counter() - t0
        COUNTS[name] += 1
        return out
    return wrap


def main():
    frames = 100
    seq = two_plane_stereo_sequence(n_frames=frames, h=480, w=640, seed=3,
                                    motion_scale=0.9, path="loop",
                                    amplitude=6.0, blobs=800,
                                    detail_octaves=4)
    sift = SiftConfig(max_kpts=2048, max_kpts_per_octave=1024)
    slam = StereoSlam(seq.intr, seq.baseline, sift_cfg=sift,
                      slam_cfg=SlamConfig(max_keyframes=48,
                                          loop_temporal_gap=12))

    slam._local_ba = timed("local_ba", slam._local_ba)
    slam._try_loop_closure = timed("loop_closure", slam._try_loop_closure)
    slam._optimize_graph = timed("pose_graph", slam._optimize_graph)
    # fused path (round 5): replicate _kf_event with host-prep / upload /
    # dispatch / fetch segment timers
    import jax.numpy as jnp
    import cusift_tpu.models.slam as _ms

    def kf_event(j):
        t0 = time.perf_counter()
        s = slam.state
        e = len(s.edge_i)
        ecap = max(64, -(-(e + 1) // 64) * 64)
        pad = ecap - e
        kfcap = slam.cfg.max_keyframes
        limit = max(0, s.n_kf - 1 - slam.cfg.loop_temporal_gap)
        ints = np.concatenate([
            np.array([j, s.n_kf, e, limit], np.int32),
            np.asarray(s.edge_i, np.int32), np.zeros(pad, np.int32),
            np.asarray(s.edge_j, np.int32), np.zeros(pad, np.int32)])
        eyepad = np.broadcast_to(np.eye(3, dtype=np.float32),
                                 (pad, 3, 3))
        meas_r = (np.concatenate([np.stack(s.meas_r), eyepad]) if e
                  else eyepad.copy())
        meas_t = np.zeros((ecap, 3), np.float32)
        wts = np.zeros(ecap, np.float32)
        if e:
            meas_t[:e] = np.stack(s.meas_t)
            wts[:e] = s.weight
        host_blob = np.concatenate([
            ints.view(np.float32),
            s.kf_pose_r.ravel(), s.kf_pose_t.ravel(),
            meas_r.ravel(), meas_t.ravel(), wts,
        ]).astype(np.float32)
        t1 = time.perf_counter()
        TIMES["ev_host_prep"] += t1 - t0
        blob = jnp.asarray(host_blob)
        t2 = time.perf_counter()
        TIMES["ev_upload"] += t2 - t1
        dev = _ms._kf_event_step(
            s.kf_desc, s.kf_valid, s.kf_pts, slam.intr, blob,
            slam._next_key(), slam.cfg.local_ba_window, slam.match_cfg,
            slam.ransac_cfg, slam._ba_cfg, slam._pg_dense,
            slam.cfg.loop_min_score, slam.cfg.loop_min_inliers)
        t3 = time.perf_counter()
        TIMES["ev_dispatch"] += t3 - t2
        packed = np.asarray(dev)
        t4 = time.perf_counter()
        TIMES["ev_fetch"] += t4 - t3
        k9 = kfcap * 9
        k12 = kfcap * 12
        s.kf_pose_r = packed[:k9].reshape(kfcap, 3, 3).copy()
        s.kf_pose_t = packed[k9:k12].reshape(kfcap, 3).copy()
        cand, _score, accept, _inl = packed[k12:k12 + 4]
        if accept > 0:
            slam._add_edge(int(cand), j,
                           packed[k12 + 6:k12 + 15].reshape(3, 3).copy(),
                           packed[k12 + 15:k12 + 18].copy(), 2.0)
            s.n_closures += 1
        TIMES["ev_apply"] += time.perf_counter() - t4
        COUNTS["kf_event"] += 1
        for k in ("ev_host_prep", "ev_upload", "ev_dispatch", "ev_fetch",
                  "ev_apply"):
            COUNTS[k] = COUNTS["kf_event"]
        return bool(accept > 0)

    slam._kf_event = kf_event
    slam._add_keyframe = timed("add_keyframe", slam._add_keyframe)
    slam._evict_keyframe = timed("evict", slam._evict_keyframe)
    slam._chunk_sense_step = timed("chunk_dispatch", slam._chunk_sense_step)
    orig_commit = slam._commit

    def commit(feats, pts, packed, ref, index=None):
        t0 = time.perf_counter()
        packed = np.asarray(packed)
        TIMES["fetch_or_wait"] += time.perf_counter() - t0
        COUNTS["fetch_or_wait"] += 1
        t0 = time.perf_counter()
        out = orig_commit(feats, pts, packed, ref, index)
        TIMES["commit_host"] += time.perf_counter() - t0
        COUNTS["commit_host"] += 1
        return out

    slam._commit = commit

    pairs = list(zip(seq.images_l, seq.images_r))
    t0 = time.time()
    slam.run(pairs[:9], chunk=8)        # bootstrap + first chunk compile
    compile_s = time.time() - t0
    for k in list(TIMES):
        TIMES[k] = 0.0
        COUNTS[k] = 0
    t0 = time.time()
    slam.run(pairs[9:frames], chunk=8)
    wall = time.time() - t0

    n = frames - 9
    rep = {"frames": n, "wall_s": round(wall, 2), "compile_s": round(
        compile_s, 1), "ms_per_frame": round(1e3 * wall / n, 1),
        "keyframes": slam.state.n_kf_total, "closures": slam.state.n_closures}
    for k in sorted(TIMES, key=TIMES.get, reverse=True):
        rep[k] = {"total_ms": round(1e3 * TIMES[k], 1), "n": COUNTS[k],
                  "ms_per_frame": round(1e3 * TIMES[k] / n, 2)}
    print(json.dumps(rep, indent=1))


if __name__ == "__main__":
    main()
