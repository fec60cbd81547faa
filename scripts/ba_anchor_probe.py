"""Time window_ba landmark anchoring: "newest" vs "union" (VERDICT r2 task 6).

Synthetic W-keyframe window with realistic overlap (every keyframe sees a
rotating subset of one landmark field): queue `iters` dispatches, then
fetch one scalar derived from the outputs.

Run (GPU):  PYTHONPATH=. python scripts/ba_anchor_probe.py
Run (CPU):  JAX_PLATFORMS=cpu \
            PYTHONPATH=. python scripts/ba_anchor_probe.py --iters 3
"""

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from cusift_tpu.config import BAConfig, MatchConfig
from cusift_tpu.models.local_ba import window_ba


def make_window(rng, w, n, overlap=0.6):
    """W keyframes observing one 3-D point field with partial overlap."""
    n_world = int(n * (1 + (1 - overlap) * (w - 1)))
    pts_w = np.stack([rng.uniform(-4, 4, n_world),
                      rng.uniform(-3, 3, n_world),
                      rng.uniform(4, 12, n_world)], -1).astype(np.float32)
    desc_w = rng.normal(size=(n_world, 128)).astype(np.float32)
    desc_w /= np.linalg.norm(desc_w, axis=-1, keepdims=True)
    kd, kv, kp, rs, ts = [], [], [], [], []
    for k in range(w):
        # camera k translated along x; sees a sliding slice of the field
        t = np.array([0.25 * k, 0.0, 0.0], np.float32)
        r = np.eye(3, dtype=np.float32)
        start = int(k * n * (1 - overlap))
        sel = np.arange(start, start + n) % n_world
        cam = pts_w[sel] @ r.T + t
        kd.append(desc_w[sel])
        kv.append(np.ones(n, bool))
        kp.append(cam)
        rs.append(r)
        ts.append(t)
    return (jnp.asarray(np.stack(kd)), jnp.asarray(np.stack(kv)),
            jnp.asarray(np.stack(kp)), jnp.asarray(np.stack(rs)),
            jnp.asarray(np.stack(ts)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--window", type=int, default=5)
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    intr = jnp.asarray(np.array([320.0, 320.0, 160.0, 120.0], np.float32))
    ba_cfg = BAConfig(max_iters=5, cg_iters=15, num_fixed_poses=2,
                      huber_delta=4.0)
    mc = MatchConfig()
    for n in (1024, 4096):
        kd, kv, kp, r0, t0 = make_window(rng, args.window, n)
        # perturb the non-gauge poses so LM has real work to do
        t0 = t0.at[2:].add(jnp.asarray(
            rng.normal(0, 0.02, (args.window - 2, 3)).astype(np.float32)))
        mask = jnp.ones(args.window, jnp.float32)
        for anchor in ("newest", "union"):
            # warm (compile)
            t_c0 = time.perf_counter()
            r, t, c0, c1 = window_ba(kd, kv, kp, r0, t0, intr, mask,
                                     mc, ba_cfg, anchor=anchor)
            _ = float(c1)
            compile_s = time.perf_counter() - t_c0
            # honest steady-state: queue iters dispatches, fetch one scalar
            t_0 = time.perf_counter()
            acc = None
            for _ in range(args.iters):
                r, t, c0, c1 = window_ba(kd, kv, kp, r0, t0, intr, mask,
                                         mc, ba_cfg, anchor=anchor)
                acc = c1 if acc is None else acc + c1 + jnp.sum(t)
            _ = float(acc)
            ms = 1e3 * (time.perf_counter() - t_0) / args.iters
            print(json.dumps({"anchor": anchor, "n": n,
                              "w": args.window,
                              "ms_per_call": round(ms, 2),
                              "compile_s": round(compile_s, 1),
                              "final_cost": round(float(c1), 4)}),
                  flush=True)


if __name__ == "__main__":
    main()
