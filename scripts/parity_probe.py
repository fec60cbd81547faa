"""Decompose the cv2.SIFT parity gap (VERDICT r3 task 6; SURVEY §7 P2).

The parity row has sat at 84% keypoint overlap against the >= 85% exit
bar for two rounds, with the residual ATTRIBUTED to approx_max_k's 0.95
recall but never isolated.  This probe runs the parity config ablations
on the CPU backend and prints the overlap per variant:

  base      the measured parity config (upscale, approx top-k)
  exact     approx_topk=False — isolates the approx_max_k recall share
  bigbudget exact top-k + 2x per-octave budgets — isolates budget binding
  wideborder border=2 (cv2 uses the descriptor support, not a fixed 5 px
            margin; our border gate may reject edge keypoints cv2 keeps)
  all       every relaxation together — the residual after this is
            genuine algorithmic difference (threshold semantics, refine
            behaviour), i.e. the irreducible envelope gap

Run: JAX_PLATFORMS=cpu \
     PYTHONPATH=.:tests python scripts/parity_probe.py
"""

import json

import numpy as np

from cusift_tpu.config import SiftConfig, replace
from cusift_tpu.data.synthetic import textured_image
from cusift_tpu.models.sift import extract

from oracle import cosine, cv2_sift_oracle, greedy_keypoint_match

BASE = SiftConfig(max_kpts=4096, max_kpts_per_octave=2048, upscale=True)


def overlap_for(cfg: SiftConfig, img, matched_retention: bool = False) -> dict:
    """matched_retention: cap cv2 at OUR valid count (nfeatures=N keeps
    the strongest N) — both engines at the same retention budget.  The
    uncapped comparison conflates detector agreement with budget size:
    cv2 unbounded finds every weak extremum while our static capacity by
    design keeps the strongest K."""
    f = extract(img, cfg)
    v = np.asarray(f.valid)
    xy = np.stack([np.asarray(f.x)[v], np.asarray(f.y)[v]], -1)
    sg = np.asarray(f.sigma)[v]
    dsc = np.asarray(f.desc)[v]
    nf = int(v.sum()) if matched_retention else 0
    oxy, osig, _, odesc, oresp = cv2_sift_oracle(img, n_features=nf,
                                                 with_response=True)
    pairs = greedy_keypoint_match(oxy, xy, osig, sg)
    i, j = np.array(pairs).T
    cs = cosine(odesc[i], dsc[j])

    def uniq(pts, sig):
        """Dedupe orientation-duplicate slots: one entry per distinct
        (x, y, log sigma) cell.  cv2 emits EVERY histogram peak >= 0.8x
        max as its own keypoint while we cap at max_orientations=2, so
        slot-level overlap undercounts detector agreement."""
        key = np.round(np.concatenate(
            [pts / 0.5, np.log(np.maximum(sig, 1e-9))[:, None] / 0.05],
            axis=1)).astype(np.int64)
        _, idx = np.unique(key, axis=0, return_index=True)
        return pts[idx], sig[idx]

    uoxy, uosig = uniq(oxy, osig)
    uxy, usg = uniq(xy, sg)
    upairs = greedy_keypoint_match(uoxy, uxy, uosig, usg)
    # coverage per oracle response strength: where does disagreement live?
    matched = np.zeros(len(oxy), bool)
    matched[i] = True
    order = np.argsort(-oresp)
    half = order[:max(len(order) // 2, 1)]
    quarter = order[:max(len(order) // 4, 1)]
    return dict(ours=int(v.sum()), cv2=len(oxy),
                overlap=round(len(pairs) / max(len(oxy), 1), 4),
                uniq_ours=len(uxy), uniq_cv2=len(uoxy),
                uniq_overlap=round(len(upairs) / max(len(uoxy), 1), 4),
                strong_half_cov=round(float(matched[half].mean()), 4),
                strong_quarter_cov=round(float(matched[quarter].mean()), 4),
                desc_cos_med=round(float(np.median(cs)), 4))


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="r1bench",
                    choices=("plain", "bench", "r1bench"),
                    help="'r1bench' = the round-1 bench scene (~3k kpts at "
                         "480p — the BASELINE 84%% parity row's class); "
                         "'plain' = bare textured_image (sparse, ~140 "
                         "kpts); 'bench' = the dense multi-octave scene")
    args = ap.parse_args()
    if args.scene == "bench":
        img = textured_image(480, 640, seed=0, blobs=800, detail=0.25,
                             detail_octaves=4)
    elif args.scene == "r1bench":
        img = textured_image(480, 640, seed=1, blobs=800, detail=0.25)
    else:
        img = textured_image(480, 640, seed=2)
    variants = {
        "base": BASE,
        "exact": replace(BASE, approx_topk=False),
        "bigbudget": replace(BASE, approx_topk=False, max_kpts=8192,
                             max_kpts_per_octave=4096),
        "wideborder": replace(BASE, border=2),
        "all": replace(BASE, approx_topk=False, max_kpts=8192,
                       max_kpts_per_octave=4096, border=2),
        # effectively uncapped: per-octave budgets above any scene's true
        # extrema count, so only detector semantics differ
        "uncapped": replace(BASE, approx_topk=False, max_kpts=16384,
                            max_kpts_per_octave=14336),
    }
    for name, cfg in variants.items():
        print(name, json.dumps(overlap_for(cfg, img)), flush=True)
    # matched retention: both engines keep their strongest N
    for name in ("base", "exact", "bigbudget", "uncapped"):
        print(name + "+matched",
              json.dumps(overlap_for(variants[name], img,
                                     matched_retention=True)), flush=True)


if __name__ == "__main__":
    main()
