"""Per-octave candidate-yield diagnostic (CPU): where do budget slots die?

For each octave: true extrema count (finite scores), candidate budget,
refine-survivor count, and the global valid total.  Run with different
scenes/configs to find the config where the bench scene yields ~4k
keypoints (62f0428:BASELINE.md density note / VERDICT round-3 task 1a).
"""

import argparse

import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

from cusift_tpu.config import SiftConfig, replace
from cusift_tpu.data.synthetic import warped_pair
from cusift_tpu.models.sift import _octave_planes, extract
from cusift_tpu.ops.detect import detect_from_score


def probe(img, cfg, tag):
    img = jnp.asarray(img)
    tot_extrema = tot_budget = tot_valid = 0
    print(f"--- {tag}")
    for oi, (samp, dog, score) in enumerate(_octave_planes(img, cfg)):
        n_ext = int(jnp.isfinite(score).sum())
        k = cfg.kpt_budget(oi)
        kps = detect_from_score(dog, score, oi, cfg)
        n_val = int(kps.valid.sum())
        tot_extrema += n_ext
        tot_budget += k
        tot_valid += n_val
        print(f"  oct{oi} {dog.shape[1]}x{dog.shape[2]}: extrema={n_ext:5d} "
              f"budget={k:5d} refined_valid={n_val:5d} "
              f"({'SATURATED' if n_ext > k else 'room'})")
    f = extract(img, cfg)
    n_slots = int(f.valid.sum())
    print(f"  totals: extrema={tot_extrema} budget={tot_budget} "
          f"valid={tot_valid} final_slots={n_slots}/{cfg.total_kpts}")
    return n_slots


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, nargs=2, default=(480, 640))
    ap.add_argument("--blobs", type=int, default=800)
    ap.add_argument("--detail", type=float, default=0.25)
    ap.add_argument("--detail-octaves", type=int, default=1)
    ap.add_argument("--budgets", type=int, nargs="*", default=None)
    ap.add_argument("--max-kpts", type=int, default=4096)
    ap.add_argument("--mkpo", type=int, default=None)
    ap.add_argument("--no-decay", action="store_true")
    args = ap.parse_args()
    h, w = args.size
    img, _, _ = warped_pair(h, w, seed=1, blobs=args.blobs, detail=args.detail,
                            detail_octaves=args.detail_octaves)
    cfg = SiftConfig(max_kpts=args.max_kpts,
                     max_kpts_per_octave=args.mkpo or args.max_kpts // 2,
                     upscale=True)
    if args.no_decay:
        cfg = replace(cfg, octave_budget_decay=False)
    if args.budgets:
        cfg = replace(cfg, octave_budgets=tuple(args.budgets))
    probe(img, cfg, f"blobs={args.blobs} detail={args.detail}x{args.detail_octaves} "
          f"mkpo={cfg.max_kpts_per_octave} decay={cfg.octave_budget_decay}")


if __name__ == "__main__":
    main()
