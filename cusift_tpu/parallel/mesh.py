"""Device mesh bootstrap (SURVEY.md §2.4 D1, D6).

The reference has no distribution at all (single GPU, no NCCL/MPI); this
engine scales through `jax.sharding.Mesh` with two logical axes:

* ``frames`` — data parallelism over frames/keyframes (throughput),
* ``map``    — sharding of landmarks/observations (memory + BA compute).

One code path covers 1 device -> several hosts: XLA lowers the
collectives (to NCCL on GPUs) from the mesh; nothing here speaks NCCL
directly, and no axis assumes a link topology (the cards of one host are
joined all to all).  Multi-host
process bootstrap is `jax.distributed.initialize()` (no-op on one host).
"""

from __future__ import annotations


import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed() -> None:
    """Initialise multi-host JAX if env vars are present (idempotent)."""
    import os
    if os.environ.get("JAX_COORDINATOR_ADDRESS"):
        try:
            jax.distributed.initialize()
        except (RuntimeError, ValueError):
            pass  # already initialised


def make_mesh(frames: int | None = None, map_: int | None = None,
              devices=None) -> Mesh:
    """Mesh over ("frames", "map").

    Defaults: all devices on "frames" (extraction throughput) unless `map_`
    is given.  frames * map_ must cover all devices used.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if frames is None and map_ is None:
        frames, map_ = n, 1
    elif frames is None:
        frames = n // map_
    elif map_ is None:
        map_ = n // frames
    assert frames * map_ <= n, f"mesh {frames}x{map_} > {n} devices"
    devs = devices[: frames * map_].reshape(frames, map_)
    return Mesh(devs, ("frames", "map"))


def map_mesh(n: int | None = None, devices=None) -> Mesh:
    """1 x N mesh putting all devices on the "map" axis (distributed BA)."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = n or devices.size
    return Mesh(devices[:n].reshape(1, n), ("frames", "map"))


def frames_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch of frames) axis."""
    return NamedSharding(mesh, P("frames"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
