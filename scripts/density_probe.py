"""How many keypoints does the bench scene yield vs texture density?

The CudaSift-class calibration (62f0428:BASELINE.md) assumes ~4k keypoints per
frame; the static pipeline pays the full max_kpts budget regardless of
how many are real, so a bench scene that fills the budget is the
workload-aligned comparison.  Run: PYTHONPATH=. python scripts/density_probe.py
"""

import time

import numpy as np


def main():
    import jax
    from cusift_tpu.utils.device import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    from cusift_tpu.config import SiftConfig
    from cusift_tpu.models.sift import extract
    from cusift_tpu.data.synthetic import warped_pair

    cfg = SiftConfig(max_kpts=4096, max_kpts_per_octave=2048, upscale=True)
    for blobs, detail in ((800, 0.25), (1200, 0.35), (1600, 0.45),
                          (2000, 0.6)):
        a, b, _ = warped_pair(480, 640, seed=1, blobs=blobs, detail=detail)
        t0 = time.perf_counter()
        n = int(extract(jnp.asarray(a), cfg).count)
        print(f"blobs={blobs} detail={detail}: kpts={n} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)


if __name__ == "__main__":
    main()
