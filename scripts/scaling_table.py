"""Scaling table over the virtual CPU mesh (VERDICT round-3 task 8).

Collective-overhead / correctness curve at 1/2/4/8 devices for the two
production distributed paths: frames-sharded extraction (D2) and the
streaming distributed window BA (D4).  This is NOT hardware scaling —
the virtual CPU mesh shares the host's cores, so speedups are
meaningless; what the table certifies is that the sharded programs
compile, run, and return per-device-count IDENTICAL results while the
collective overhead stays bounded.  Run:

  JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    PYTHONPATH=. python scripts/scaling_table.py
"""

import json
import time

import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

from cusift_tpu.config import BAConfig, MatchConfig, SiftConfig
from cusift_tpu.data.synthetic import planar_rgbd_sequence, textured_image
from cusift_tpu.models.local_ba import window_ba
from cusift_tpu.models.slam import _extract_with_points
from cusift_tpu.parallel.dist_ba import window_ba_dist
from cusift_tpu.parallel.mesh import make_mesh, map_mesh
from cusift_tpu.parallel.sharded import extract_frames

CFG = SiftConfig(max_kpts=256, max_kpts_per_octave=128, num_octaves=3)


def timed(fn, *args, iters=3):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return out, (time.perf_counter() - t0) / iters


def main():
    n_dev = len(jax.devices())
    counts = [c for c in (1, 2, 4, 8) if c <= n_dev]

    imgs = jnp.asarray(np.stack([textured_image(240, 320, seed=s, blobs=120,
                                                detail=0.25)
                                 for s in range(8)]))
    seq = planar_rgbd_sequence(5, 240, 320, seed=5, motion_scale=0.8,
                               detail=0.3)
    descs, valids, ptss = [], [], []
    for i in range(5):
        f, pts, _ = _extract_with_points(
            jnp.asarray(seq.images[i]), jnp.asarray(seq.depths[i]),
            jnp.asarray(seq.intr), CFG)
        descs.append(f.desc)
        valids.append(f.valid)
        ptss.append(pts)
    ba_args = (jnp.stack(descs), jnp.stack(valids), jnp.stack(ptss),
               jnp.asarray(seq.poses_r), jnp.asarray(seq.poses_t),
               jnp.asarray(seq.intr), jnp.ones(5, jnp.float32))
    ba_cfg = BAConfig(max_iters=5, cg_iters=15, num_fixed_poses=2,
                      huber_delta=4.0)

    ref_counts = None
    ref_cost = None
    for c in counts:
        mesh = make_mesh(frames=c, map_=1, devices=np.array(jax.devices()[:c]))
        feats, t_ex = timed(
            lambda im: extract_frames(im, mesh, CFG), imgs)
        kcounts = np.asarray(feats.valid.sum(-1))
        if c == 1:
            r, t, c0, c1 = window_ba(*ba_args, MatchConfig(), ba_cfg)
            t0 = time.perf_counter()
            for _ in range(3):
                r, t, c0, c1 = window_ba(*ba_args, MatchConfig(), ba_cfg)
            jax.block_until_ready(t)
            t_ba = (time.perf_counter() - t0) / 3
        else:
            bmesh = map_mesh(c, devices=np.array(jax.devices()[:c]))
            (r, t, c0, c1), t_ba = timed(
                lambda *a: window_ba_dist(*a, bmesh, MatchConfig(), ba_cfg),
                *ba_args)
        if ref_counts is None:
            ref_counts, ref_cost = kcounts, float(c1)
        assert np.array_equal(kcounts, ref_counts), (c, kcounts, ref_counts)
        cost_dev = abs(float(c1) - ref_cost) / max(abs(ref_cost), 1e-9)
        print(json.dumps({
            "devices": c,
            "extract8_ms": round(t_ex * 1e3, 1),
            "window_ba_ms": round(t_ba * 1e3, 1),
            "ba_final_cost": round(float(c1), 4),
            "cost_rel_dev_vs_1dev": round(cost_dev, 6),
            "kpt_counts_identical": True,
        }), flush=True)


if __name__ == "__main__":
    main()
