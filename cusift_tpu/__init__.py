"""cusift_tpu — a SIFT SLAM/SfM engine in JAX for the GPU.

A from-scratch JAX/XLA/Pallas implementation of the capability envelope of
danielsuo/cuSIFT (GPU SIFT extraction, ratio-test matching, RANSAC
homography / 3D rigid transforms) extended to full SfM/SLAM: bundle
adjustment with Schur-complement reduction, pose-graph optimisation, loop
closure, and multi-device scaling over a `jax.sharding.Mesh`.  See SURVEY.md.
"""

from .config import (BAConfig, MatchConfig, MeshConfig, PoseGraphConfig,
                     RansacConfig, SiftConfig, SlamConfig)

__version__ = "0.1.0"

__all__ = [
    "SiftConfig", "MatchConfig", "RansacConfig", "BAConfig",
    "PoseGraphConfig", "SlamConfig", "MeshConfig",
]
