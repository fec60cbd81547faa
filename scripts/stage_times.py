"""Per-stage timing of the batched extract pipeline.

Builds jitted programs that consume progressively more of the pipeline and
reports the marginal cost of each stage (queue `iters` dispatches, then
fetch one scalar).  Run: PYTHONPATH=. python scripts/stage_times.py
"""

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--size", type=int, nargs=2, default=(480, 640))
    ap.add_argument("--max-kpts", type=int, default=4096)
    ap.add_argument("--stages", default="",
                    help="comma-separated subset (default: all)")
    args = ap.parse_args()

    import jax
    from cusift_tpu.utils.device import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from cusift_tpu.config import MatchConfig, SiftConfig
    from cusift_tpu.models.sift import _octave_planes, extract
    from cusift_tpu.ops.describe import compact_slots, descriptors
    from cusift_tpu.ops.detect import detect_from_score
    from cusift_tpu.ops.match import match
    from cusift_tpu.ops.orientation import (dominant_orientations,
                                            orientation_histograms)
    from cusift_tpu.data.synthetic import warped_pair

    h, w = args.size
    # mirror bench.py's headline config (scene-matched budgets, trimmed
    # descriptor slots) so the stage table explains the headline number
    cfg = SiftConfig(max_kpts=args.max_kpts,
                     max_kpts_per_octave=args.max_kpts // 2,
                     octave_budgets=(2048, 1024, 256, 96, 32),
                     desc_slot_factor=1.10, upscale=True)
    bsz = args.batch
    frames = []
    for s in range((bsz + 1) // 2):
        a, b, _ = warped_pair(h, w, seed=s, blobs=800, detail=0.25,
                              detail_octaves=4)
        frames.extend([a, b])
    imgs = jnp.asarray(np.stack(frames[:bsz]))

    def upto(stage):
        def one(img):
            acc = 0.0
            parts = []
            for oi, (samp, dog, score) in enumerate(_octave_planes(img, cfg)):
                if stage == "pyramid":
                    acc += jnp.sum(samp) + jnp.sum(dog)
                    continue
                if stage == "score":
                    acc += jnp.sum(jnp.where(jnp.isfinite(score), score, 0.0))
                    continue
                if stage == "topk":
                    from jax import lax
                    k = cfg.kpt_budget(oi)
                    fs, fi = lax.approx_max_k(score.reshape(-1), k,
                                              recall_target=0.95)
                    acc += jnp.sum(jnp.where(jnp.isfinite(fs), fs, 0.0))
                    acc += jnp.sum(fi)
                    continue
                kps = detect_from_score(dog, score, oi, cfg)
                if stage == "detect":
                    acc += jnp.sum(kps.xo) + jnp.sum(kps.valid)
                    continue
                hist = orientation_histograms(samp, kps, cfg, level_base=1)
                theta, ok = dominant_orientations(hist, cfg)
                if stage == "ori":
                    acc += jnp.sum(theta) + jnp.sum(ok)
                    continue
                slots = compact_slots(kps, theta, ok, cfg.desc_slots(oi))
                desc, sv = descriptors(samp, slots, cfg, level_base=1)
                acc += jnp.sum(desc) + jnp.sum(sv)
            return acc

        @jax.jit
        def run(ims):
            return jnp.sum(jax.vmap(one)(ims))

        return run

    @jax.jit
    def full(ims):
        f = jax.vmap(lambda im: extract(im, cfg))(ims)
        ms = [match(f.desc[i], f.valid[i], f.desc[i + 1], f.valid[i + 1],
                    MatchConfig()).ok.sum()
              for i in range(bsz - 1)]
        return jnp.sum(f.desc) + jnp.sum(jnp.stack(ms))

    def timed(fn, x):
        t0 = time.perf_counter()
        float(fn(x))
        compile_s = time.perf_counter() - t0
        float(fn(x))
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = fn(x)
        float(out)
        return (time.perf_counter() - t0) / args.iters, compile_s

    stages = ["pyramid", "score", "topk", "detect", "ori", "desc"]
    if args.stages:
        stages = [s for s in stages if s in args.stages.split(",")]
    prev = 0.0
    report = {}
    for st in stages:
        dt, cs = timed(upto(st), imgs)
        report[st] = {"cum_ms": round(dt * 1e3, 2),
                      "marginal_ms": round((dt - prev) * 1e3, 2),
                      "compile_s": round(cs, 1)}
        prev = dt
        print(st, json.dumps(report[st]), flush=True)
    dt, cs = timed(full, imgs)
    report["full"] = {"cum_ms": round(dt * 1e3, 2),
                      "marginal_ms": round((dt - prev) * 1e3, 2),
                      "compile_s": round(cs, 1)}
    print("full", json.dumps(report["full"]), flush=True)
    print(json.dumps({"per_frame_ms": round(dt / bsz * 1e3, 3)}))


if __name__ == "__main__":
    main()
