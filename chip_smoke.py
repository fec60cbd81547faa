"""Smoke run of the main path on the GPU, through the user entry points.

    python chip_smoke.py              # phases 0-5 on one card
    python chip_smoke.py --chips 4    # phase 6 only, on four cards

Phases (one process; nothing else opens the card):

  0. device: platform, device kind, JAX version, XLA flags, compile cache,
     `nvidia-smi` name and power limit, native loader;
  1. batched extract + match at the throughput shape (8 frames of 640x480,
     2x upscale, 6144 slots), the stage times, the step time with each
     matcher backend, and GPU-vs-CPU parity of one frame's extraction;
  2. two-view homography (`models/twoview.match_pair`) at 640x480;
  3. the fused matcher kernel against the plain XLA top-2 at HIGHEST;
  4. RGB-D SLAM (`models/slam.Slam`, the `cli slam` settings) on 30
     frames of 640x480;
  5. mono VO, stereo SLAM and the `cli sfm` reconstruction;
  6. (`--chips 4`) distributed Schur BA over four cards against one-card
     BA, and frames-sharded extraction against one-card `extract_batch`.

Each phase prints one JSON line; no phase catches its own failure.  The
last line is {"ok": true, "device": {...}}.  Without a GPU the script
exits non-zero before any phase.  Each phase is a function of its sizes,
so the CPU tests run the same code at tiny sizes.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np


def emit(name: str, rec: dict) -> dict:
    print(json.dumps({"phase": name, **rec}), flush=True)
    return rec


def _block(x):
    import jax
    return jax.block_until_ready(x)


def first_call(fn, *args):
    """(result, seconds) of a first call, compile included."""
    t0 = time.perf_counter()
    out = _block(fn(*args))
    return out, time.perf_counter() - t0


def median_ms(fn, *args, iters: int = 20, warmup: int = 2) -> float:
    """Median wall time of `fn(*args)` over `iters` calls, ms."""
    for _ in range(warmup):
        _block(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _block(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


def throughput_config(max_kpts: int = 6144):
    """bench.py's extraction config (640x480 frames, 2x upscale)."""
    from cusift_tpu.config import SiftConfig
    half = max_kpts // 2
    return SiftConfig(max_kpts=max_kpts, max_kpts_per_octave=half,
                      octave_budgets=(half, half // 2, half // 8, 96, 32),
                      upscale=True, score_dtype="bf16")


def bench_frames(n: int, h: int, w: int) -> np.ndarray:
    """[n, h, w] frames of bench.py's dense multi-octave texture."""
    from cusift_tpu.data.synthetic import warped_pair
    out = []
    for s in range((n + 1) // 2):
        a, b, _ = warped_pair(h, w, seed=s, blobs=800, detail=0.25,
                              detail_octaves=4)
        out += [a, b]
    return np.stack(out[:n])


# ---------------------------------------------------------------- phase 0

def nvidia_smi() -> str:
    """`name, power.limit` of each card, from a child that never imports JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.strip()


def phase_device(info: dict, cache_dir: str) -> dict:
    import jax
    from cusift_tpu.utils.native_loader import native_available
    smi = nvidia_smi()
    print(smi, flush=True)
    return emit("device", {
        **info, "jax": jax.__version__,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "compile_cache": cache_dir, "nvidia_smi": smi,
        "native_loader": native_available()})


# ---------------------------------------------------------------- phase 1

def stage_fns(cfg, match_cfg, interpret: bool = False):
    """The extract pipeline cut into separately jitted, vmapped stages.

    Returns [(name, fn)] where each fn maps the previous stage's output
    (the first takes the [B, H, W] frames) to its own; the sum of their
    times bounds the fused step from above (no fusion across cuts).
    """
    import jax
    from cusift_tpu.models.sift import _octave_planes
    from cusift_tpu.ops.describe import compact_slots, descriptors
    from cusift_tpu.ops.detect import detect_from_score
    from cusift_tpu.ops.match import match
    from cusift_tpu.ops.orientation import (dominant_orientations,
                                            orientation_histograms)

    def pyramid(im):
        return _octave_planes(im, cfg)

    def detect(planes):
        return planes, [detect_from_score(dog, score, oi, cfg)
                        for oi, (_, dog, score) in enumerate(planes)]

    def orient(args):
        planes, kps = args
        oris = [dominant_orientations(
            orientation_histograms(samp, k, cfg, level_base=1), cfg)
            for (samp, _, _), k in zip(planes, kps)]
        return planes, kps, oris

    def describe(args):
        planes, kps, oris = args
        out = []
        for oi, ((samp, _, _), k, (theta, ok)) in enumerate(
                zip(planes, kps, oris)):
            slots = compact_slots(k, theta, ok, cfg.desc_slots(oi))
            out.append(descriptors(samp, slots, cfg, level_base=1))
        return out

    def match_pairs(desc_valid):
        import jax.numpy as jnp
        d = jnp.concatenate([x for x, _ in desc_valid], 1)
        v = jnp.concatenate([x for _, x in desc_valid], 1)
        return match(d[:-1], v[:-1], d[1:], v[1:], match_cfg,
                     interpret=interpret)

    return [(name, jax.jit(jax.vmap(f)) if name != "match" else jax.jit(f))
            for name, f in (("pyramid_score", pyramid),
                            ("detect_topk_refine", detect),
                            ("orientation", orient),
                            ("descriptor", describe),
                            ("match", match_pairs))]


def topk_lowering(fn, *args) -> dict:
    """What the candidate top-k compiled to: op counts in the optimized HLO
    (metadata stripped, so source names do not count)."""
    import re
    text = re.sub(r"metadata=\{[^}]*\}", "",
                  fn.lower(*args).compile().as_text()).lower()
    return {k: text.count(k) for k in ("sort(", "topk", "approx")}


def parity(fa, fb) -> dict:
    """Agreement of two extractions of one frame (a: device, b: CPU).

    Unique-position overlap: share of b's unique keypoints (x, y, sigma;
    orientation slots of one keypoint count once) with a keypoint of a
    within 0.5 px and 5% of scale.  Descriptor cosine: over b's valid
    slots, the best cosine among a's slots that also agree in orientation
    to 0.1 rad.
    """
    def take(f):
        v = np.asarray(f.valid)
        return (np.stack([np.asarray(f.x)[v], np.asarray(f.y)[v]], -1),
                np.asarray(f.sigma)[v], np.asarray(f.orientation)[v],
                np.asarray(f.desc)[v])

    xa, sa, oa, da = take(fa)
    xb, sb, ob, db = take(fb)

    def near(i):
        return ((np.abs(xa - xb[i]).max(1) < 0.5)
                & (np.abs(np.log(sa / sb[i])) < 0.05))

    _, first = np.unique(np.round(np.concatenate(
        [xb, np.log(sb)[:, None]], 1), 4), axis=0, return_index=True)
    overlap = float(np.mean([near(i).any() for i in first])) \
        if len(first) else 0.0
    cos = []
    for i in range(len(xb)):
        m = near(i) & (np.abs((oa - ob[i] + np.pi) % (2 * np.pi) - np.pi)
                       < 0.1)
        if m.any():
            cos.append(float((da[m] @ db[i]).max()))
    return {"n_a": int(len(xa)), "n_b": int(len(xb)),
            "unique_overlap": overlap,
            "matched_slots": len(cos) / max(len(xb), 1),
            "median_cosine": float(np.median(cos)) if cos else 0.0}


def phase_extract_match(h: int = 480, w: int = 640, batch: int = 8,
                        cfg=None, iters: int = 20, interpret: bool = False,
                        min_overlap: float = 0.95,
                        min_cosine: float = 0.999) -> dict:
    """Batched extract + consecutive-pair match, stage times, parity.

    Parity bounds: the card and the CPU run the same f32 program, so they
    differ by summation order and fused multiply-adds (~1e-7 relative).
    That can flip candidates sitting at the contrast, edge and budget
    cuts, and the bf16 score ranking ties more of them; hence 95% of
    unique positions, not 100%.  Descriptors of slots found on both agree
    to float rounding, hence a median cosine of 0.999.
    """
    import jax
    import jax.numpy as jnp
    from cusift_tpu.config import MatchConfig
    from cusift_tpu.models.sift import extract, extract_batch
    from cusift_tpu.ops.match import match

    cfg = cfg or throughput_config()
    imgs = jnp.asarray(bench_frames(batch, h, w))
    rec = {"shape": [batch, h, w], "max_kpts": cfg.max_kpts}

    def make_step(backend):
        mcfg = MatchConfig(backend=backend)

        @jax.jit
        def step(x):
            f = extract_batch(x, cfg)
            m = match(f.desc[:-1], f.valid[:-1], f.desc[1:], f.valid[1:],
                      mcfg, interpret=interpret)
            return f.valid.sum(1), m.ok.sum(1)
        return step

    steps = {b: make_step(b) for b in ("xla", "triton")}
    compile_s = {}
    outs = {}
    for b, fn in steps.items():
        outs[b], compile_s[f"step_{b}"] = first_call(fn, imgs)
    kpts, nmatch = (np.asarray(x) for x in outs["xla"])
    rec["kpts_per_frame"] = kpts.tolist()
    rec["matches_per_pair"] = nmatch.tolist()
    rec["matches_per_pair_triton"] = np.asarray(outs["triton"][1]).tolist()
    assert (kpts > 0).all() and (nmatch > 0).all(), rec

    # step times, the two backends in turns (xla, triton, triton, xla)
    times = {b: [] for b in steps}
    for b in ("xla", "triton", "triton", "xla"):
        times[b].append(median_ms(steps[b], imgs, iters=max(iters // 2, 1)))
    rec["step_ms"] = {b: statistics.mean(t) for b, t in times.items()}
    rec["step_ms_runs"] = times

    # stage times of the same pipeline cut at stage boundaries
    stage_ms, x = {}, imgs
    for name, fn in stage_fns(cfg, MatchConfig(), interpret):
        t0 = time.perf_counter()
        if name == "detect_topk_refine":
            rec["topk_hlo_ops"] = topk_lowering(fn, x)
        y = _block(fn(x))
        compile_s[name] = time.perf_counter() - t0
        stage_ms[name] = median_ms(fn, x, iters=iters)
        x = y
    rec["stage_ms"] = stage_ms

    # parity: one frame through the same jitted extract on each device
    cpu = jax.devices("cpu")[0]
    dev = jax.devices()[0]
    f_dev = extract(jax.device_put(imgs[0], dev), cfg)
    f_cpu, compile_s["extract_cpu"] = first_call(
        extract, jax.device_put(np.asarray(imgs[0]), cpu), cfg)
    par = parity(f_dev, f_cpu)
    rec["parity"] = par
    rec["compile_s"] = compile_s
    emit("extract_match", rec)
    assert par["unique_overlap"] >= min_overlap, par
    assert par["median_cosine"] >= min_cosine, par
    rec["_feats"] = extract_batch(imgs, cfg)
    return rec


# ---------------------------------------------------------------- phase 2

def phase_twoview(h: int = 480, w: int = 640, sift_cfg=None,
                  ransac_cfg=None, max_err_px: float = 2.0) -> dict:
    """Homography of a warped pair; corner transfer error against H_true."""
    import jax.numpy as jnp
    from cusift_tpu.config import MatchConfig, RansacConfig, SiftConfig
    from cusift_tpu.data.synthetic import warped_pair
    from cusift_tpu.models.twoview import match_pair

    sift_cfg = sift_cfg or SiftConfig()
    ransac_cfg = ransac_cfg or RansacConfig()
    ia, ib, h_true = warped_pair(h, w, seed=3)
    res, comp = first_call(
        lambda a, b: match_pair(a, b, sift_cfg, MatchConfig(), ransac_cfg),
        jnp.asarray(ia), jnp.asarray(ib))
    corners = np.array([[0, 0, 1], [w - 1, 0, 1], [w - 1, h - 1, 1],
                        [0, h - 1, 1]], np.float64).T

    def xfer(hm):
        q = np.asarray(hm, np.float64) @ corners
        return (q[:2] / q[2:]).T

    err = float(np.abs(xfer(res.homography.h) - xfer(h_true)).max())
    rec = emit("twoview", {
        "kpts_a": int(res.feats_a.count), "kpts_b": int(res.feats_b.count),
        "matches": int(np.asarray(res.matches.ok).sum()),
        "inliers": int(res.homography.num_inliers),
        "corner_err_px": err, "compile_s": comp})
    assert err < max_err_px, rec
    return rec


# ---------------------------------------------------------------- phase 3

def phase_matcher(desc, valid, iters: int = 20, interpret: bool = False,
                  tie_tol: float = 2e-3, min_ok_share: float = 0.99,
                  timing_shapes=((7, 6144), (3, 6144), (1, 6144),
                                 (1, 2048), (7, 1024), (1, 1024))) -> dict:
    """Fused kernel against the plain XLA top-2 at Precision.HIGHEST.

    desc [B, N, 128], valid [B, N]: the B-1 consecutive pairs are matched
    in one call.  Tolerances: the kernel multiplies in TF32 (~1e-3 worst
    case on a correlation of unit vectors), so the best index must agree
    wherever best and second best differ by more than `tie_tol`; the ok
    masks differ only for ratios within that error of the 0.8 threshold,
    so they must agree on `min_ok_share` of the valid rows.

    Then the kernel and XLA at HIGH are timed on the leading (pairs,
    slots) corners of the input given by `timing_shapes`: the 8-frame
    batch (7 x 6,144), single pairs (two-view and SfM at the default 2,048
    slots) and 1,024-slot pairs (the SLAM window and retrieval matches).  `"auto"` in
    ops/match.py:resolve_backend picks between the two from these.
    """
    import jax
    from jax import lax
    from cusift_tpu.config import MatchConfig
    from cusift_tpu.ops.match import match, resolve_backend, xla_top2
    from cusift_tpu.ops.pallas.matcher import BN, top2

    a, va, b, vb = desc[:-1], valid[:-1], desc[1:], valid[1:]
    ref = jax.jit(lambda *x: xla_top2(*x, precision=lax.Precision.HIGHEST))
    xla = jax.jit(xla_top2)
    ker = jax.jit(lambda *x: top2(*x, interpret=interpret))
    (r1, r2, ri), c_ref = first_call(ref, a, b, vb)
    (k1, k2, ki), c_ker = first_call(ker, a, b, vb)
    r1, r2, ri, k1, ki = (np.asarray(x) for x in (r1, r2, ri, k1, ki))
    rows = np.asarray(va)
    clear = rows & (r1 - r2 > tie_tol)
    idx_agree = bool((ri[clear] == ki[clear]).all())
    m_ref = match(a, va, b, vb, MatchConfig(backend="xla"))
    m_ker = match(a, va, b, vb, MatchConfig(backend="triton"),
                  interpret=interpret)
    ok_share = float((np.asarray(m_ref.ok) == np.asarray(m_ker.ok))[rows]
                     .mean())
    rec = {"pairs": int(a.shape[0]), "n": int(a.shape[1]),
           "m": int(b.shape[1]),
           "clear_rows": int(clear.sum()), "idx_agree": idx_agree,
           "ok_agree_share": ok_share,
           "max_abs_s1_err": float(np.abs(k1 - r1)[rows].max()),
           "compile_s": {"ref": c_ref, "kernel": c_ker}}
    rec["ms"] = {"kernel_triton": median_ms(ker, a, b, vb, iters=iters),
                 "xla_high": median_ms(xla, a, b, vb, iters=iters),
                 "xla_highest": median_ms(ref, a, b, vb, iters=iters)}
    shapes = sorted({(min(p, a.shape[0]), min(n, a.shape[1]))
                     for p, n in timing_shapes}, reverse=True)
    rec["by_shape"] = []
    for p, n in shapes:
        x = (a[:p, :n], b[:p, :n], vb[:p, :n])
        rec["by_shape"].append({
            "pairs": p, "slots": n, "blocks": p * -(-n // BN),
            "auto": resolve_backend(MatchConfig(), p * n),
            "kernel_ms": median_ms(ker, *x, iters=iters),
            "xla_high_ms": median_ms(xla, *x, iters=iters)})
    emit("matcher", rec)
    assert idx_agree and ok_share >= min_ok_share, rec
    return rec


# ---------------------------------------------------------------- phase 4

def phase_slam(n_frames: int = 30, h: int = 480, w: int = 640,
               sift_cfg=None, slam_cfg=None, max_ate: float = 0.05) -> dict:
    """RGB-D SLAM over one second of TUM-rate input (`cli slam` settings)."""
    from cusift_tpu.config import RansacConfig, SiftConfig, SlamConfig
    from cusift_tpu.data.synthetic import planar_rgbd_sequence
    from cusift_tpu.models.slam import Slam

    seq = planar_rgbd_sequence(n_frames=n_frames, h=h, w=w, seed=0,
                               motion_scale=0.8)
    slam = Slam(seq.intr,
                sift_cfg=sift_cfg or SiftConfig(max_kpts=1024,
                                                max_kpts_per_octave=512),
                ransac_cfg=RansacConfig(inlier_thresh_3d=0.03),
                slam_cfg=slam_cfg or SlamConfig())
    t0 = time.perf_counter()
    recs = slam.run(zip(seq.images, seq.depths))
    wall = time.perf_counter() - t0
    ate = float(slam.ate(seq.poses_r, seq.poses_t))
    rec = emit("slam", {
        "frames": len(recs), "tracked": sum(bool(r.get("tracked", True))
                                            for r in recs),
        "keyframes": int(slam.state.n_kf_total),
        "window_ba_events": int(slam.state.n_window_ba),
        "closures": int(slam.state.n_closures), "ate_m": ate,
        "wall_s_incl_compile": wall})
    assert rec["keyframes"] >= 2 and rec["window_ba_events"] >= 1, rec
    assert ate < max_ate, rec
    return rec


# ---------------------------------------------------------------- phase 5

def phase_other(n_frames: int = 8, h: int = 480, w: int = 640,
                sift_cfg=None, min_tracked: float = 0.8) -> dict:
    """Mono VO, stereo SLAM and the `cli sfm` reconstruction, a few frames."""
    from cusift_tpu.config import BAConfig, RansacConfig, SiftConfig, SlamConfig
    from cusift_tpu.data.evaluation import ate_rmse
    from cusift_tpu.data.synthetic import (planar_rgbd_sequence,
                                           two_plane_sequence,
                                           two_plane_stereo_sequence)
    from cusift_tpu.models.odometry import MonoVO
    from cusift_tpu.models.sfm import reconstruct_rgbd
    from cusift_tpu.models.stereo import StereoSlam

    sift_cfg = sift_cfg or SiftConfig(max_kpts=1024, max_kpts_per_octave=512)
    rec = {}

    t0 = time.perf_counter()
    seq = two_plane_sequence(n_frames=n_frames, h=h, w=w, seed=0)
    vo = MonoVO(seq.intr, sift_cfg=sift_cfg, ransac_cfg=RansacConfig())
    er, _ = vo.run(iter(seq.images))
    rec["mono_vo"] = {"frames": len(er),
                      "tracked_pairs": sum(1 for s in vo.stats if s["ok"]),
                      "pairs": len(vo.stats),
                      "wall_s": time.perf_counter() - t0}

    t0 = time.perf_counter()
    sseq = two_plane_stereo_sequence(n_frames=n_frames, h=h, w=w, seed=0,
                                     motion_scale=0.7, amplitude=2.0)
    st = StereoSlam(sseq.intr, sseq.baseline, sift_cfg=sift_cfg,
                    ransac_cfg=RansacConfig(inlier_thresh_3d=0.05),
                    slam_cfg=SlamConfig())
    recs = st.run(zip(sseq.images_l, sseq.images_r))
    sr, stt = st.trajectory()
    rec["stereo"] = {"frames": len(recs),
                     "tracked": sum(bool(r.get("tracked", True))
                                    for r in recs),
                     "keyframes": int(st.state.n_kf_total),
                     "ate_m": float(ate_rmse(sr, stt, sseq.poses_r,
                                             sseq.poses_t)),
                     "wall_s": time.perf_counter() - t0}

    t0 = time.perf_counter()
    pseq = planar_rgbd_sequence(n_frames=n_frames, h=h, w=w, seed=0,
                                motion_scale=0.6)
    sfm = reconstruct_rgbd(pseq.images, pseq.depths, pseq.intr,
                           sift_cfg=sift_cfg,
                           ransac_cfg=RansacConfig(inlier_thresh_3d=0.03),
                           ba_cfg=BAConfig(huber_delta=4.0,
                                           num_fixed_poses=2))
    rec["sfm"] = {"frames": n_frames, "tracks": int(sfm.n_tracks),
                  "observations": int(sfm.n_obs),
                  "ba_cost": [float(sfm.ba.initial_cost), float(sfm.ba.cost)],
                  "ate_m": float(ate_rmse(sfm.poses_r, sfm.poses_t,
                                          pseq.poses_r, pseq.poses_t)),
                  "wall_s": time.perf_counter() - t0}
    emit("other_entry_points", rec)
    mono, stereo, sf = rec["mono_vo"], rec["stereo"], rec["sfm"]
    assert mono["tracked_pairs"] >= min_tracked * mono["pairs"], rec
    assert stereo["tracked"] >= min_tracked * stereo["frames"], rec
    assert sf["tracks"] > 0 and sf["ba_cost"][1] <= sf["ba_cost"][0], rec
    assert np.isfinite(sfm.poses_t).all(), rec
    return rec


# ---------------------------------------------------------------- phase 6

def phase_multichip(n_dev: int = 4, n_cams: int = 32, n_pts: int = 65536,
                    h: int = 480, w: int = 640, batch: int = 8,
                    cfg=None, ba_cfg=None, cost_rtol: float = 1e-3) -> dict:
    """Distributed Schur BA and frames-sharded extraction on `n_dev` cards.

    BA: the same problem solved on one card; the sharded solve sums the
    reduced camera system in another order (psum), so the final costs
    agree to `cost_rtol`, not bit for bit.  Extraction: every frame runs
    the same single-frame program on its card, so per-frame valid counts
    must be equal and descriptors equal to float rounding.
    """
    import jax
    import jax.numpy as jnp
    from cusift_tpu.config import BAConfig
    from cusift_tpu.data.synthetic import ba_problem
    from cusift_tpu.models.sift import extract_batch
    from cusift_tpu.optim.ba import BAProblem, bundle_adjust
    from cusift_tpu.parallel.dist_ba import (distributed_bundle_adjust,
                                             partition_by_landmark)
    from cusift_tpu.parallel.mesh import make_mesh, map_mesh
    from cusift_tpu.parallel.sharded import extract_frames

    devs = jax.devices()[:n_dev]
    assert len(devs) == n_dev, f"need {n_dev} devices, have {devs}"
    ba_cfg = ba_cfg or BAConfig(max_iters=10, cg_iters=30, num_fixed_poses=2)
    prob, _ = ba_problem(seed=0, n_cams=n_cams, n_pts=n_pts, pixel_noise=0.5)
    single_prob = BAProblem(**{k: jax.device_put(v, devs[0])
                               for k, v in prob.items()})
    single, c_single = first_call(lambda p: bundle_adjust(p, ba_cfg),
                                  single_prob)
    parts = partition_by_landmark(prob, n_dev)
    mesh = map_mesh(n_dev)
    dist, c_dist = first_call(
        lambda p: distributed_bundle_adjust(p, mesh, ba_cfg), parts)
    ms_single = median_ms(lambda p: bundle_adjust(p, ba_cfg), single_prob,
                          iters=3, warmup=0)
    ms_dist = median_ms(lambda p: distributed_bundle_adjust(p, mesh, ba_cfg),
                        parts, iters=3, warmup=0)
    costs = {"single": [float(single.initial_cost), float(single.cost)],
             "dist": [float(dist.initial_cost), float(dist.cost)]}
    rel = abs(costs["dist"][1] - costs["single"][1]) / costs["single"][1]

    cfg = cfg or throughput_config()
    imgs = bench_frames(batch, h, w)
    fmesh = make_mesh(frames=n_dev, map_=1)
    sharded, c_sh = first_call(lambda x: extract_frames(x, fmesh, cfg),
                               jnp.asarray(imgs))
    one, c_one = first_call(lambda x: extract_batch(x, cfg),
                            jax.device_put(imgs, devs[0]))
    n_sh = np.asarray(sharded.valid).sum(1)
    n_one = np.asarray(one.valid).sum(1)
    desc_err = float(np.abs(np.asarray(sharded.desc)
                            - np.asarray(one.desc)).max())
    rec = emit("multichip", {
        "devices": n_dev,
        "ba": {"observations": int(np.asarray(prob["w"]).size),
               "observations_in_image": int((np.asarray(prob["w"]) > 0)
                                            .sum()),
               "landmarks": n_pts, "cameras": n_cams, "cost": costs,
               "final_cost_rel_diff": rel,
               "ms": {"single": ms_single, "dist": ms_dist},
               "compile_s": {"single": c_single, "dist": c_dist}},
        "extract": {"frames": batch, "valid_sharded": n_sh.tolist(),
                    "valid_one_card": n_one.tolist(),
                    "max_abs_desc_diff": desc_err,
                    "compile_s": {"sharded": c_sh, "one_card": c_one}}})
    assert costs["single"][1] < costs["single"][0], rec
    assert rel <= cost_rtol, rec
    assert (n_sh == n_one).all() and desc_err < 1e-4, rec
    return rec


# ------------------------------------------------------------------ main

def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card phase (6)")
    args = ap.parse_args(argv)

    from cusift_tpu.utils.device import enable_compile_cache, require_gpu
    info = require_gpu("chip_smoke.py")
    cache_dir = enable_compile_cache()
    phase_device(info, cache_dir)
    if args.chips == 4:
        assert info["count"] == 4, f"four cards expected, found {info}"
        phase_multichip(n_dev=4)
    else:
        assert info["count"] == 1, f"one card expected, found {info}"
        p1 = phase_extract_match()
        feats = p1.pop("_feats")
        phase_twoview()
        phase_matcher(feats.desc, feats.valid)
        phase_slam()
        phase_other()
    print(json.dumps({"ok": True, "device": info}))


if __name__ == "__main__":
    main(sys.argv[1:])
