"""Trajectory-partitioned distributed pose-graph optimisation (D5).

SURVEY.md §2.4 D5 / §5.7: the structural analog of sequence/context
parallelism for this engine is the TRAJECTORY — long sequences (KITTI 00
is ~4.5k frames) partition into contiguous keyframe chunks per device.
Poses stay replicated (tiny: [N, 6] dof), edges shard by their source
keyframe so each device owns its chunk's constraints; cross-chunk edges
(odometry steps spanning a boundary, loop closures to any chunk) need no
halo exchange because the only cross-device quantities are the [N, 6]
J^T r / J^T J x vectors, each one `psum` across devices (`optim/posegraph.py:
lm_loop`).  Every device then runs the identical replicated CG — the
distributed solve is numerically the single-device solve.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..config import PoseGraphConfig
from ..optim.posegraph import PoseGraph, PoseGraphResult, lm_loop


def partition_edges(edge_i: np.ndarray, edge_j: np.ndarray,
                    meas_r: np.ndarray, meas_t: np.ndarray,
                    weight: np.ndarray, n_shards: int) -> dict:
    """Sort edges by source keyframe and pad to a shard multiple.

    Sorting by `edge_i` makes each shard's slice a contiguous trajectory
    chunk's constraints (odometry edges are naturally ordered; loop
    closures land on the chunk owning their source keyframe).  Padded
    edges carry weight 0 — `_residuals` zeroes them exactly.
    """
    order = np.argsort(edge_i, kind="stable")
    e = len(order)
    pad = (-e) % n_shards
    take = lambda a: np.concatenate(
        [np.asarray(a)[order],
         np.zeros((pad,) + np.asarray(a).shape[1:], np.asarray(a).dtype)])
    return dict(edge_i=take(edge_i.astype(np.int32)),
                edge_j=take(edge_j.astype(np.int32)),
                meas_r=take(meas_r.astype(np.float32)),
                meas_t=take(meas_t.astype(np.float32)),
                weight=take(weight.astype(np.float32)))


def distributed_pg_optimize(g: PoseGraph, mesh: Mesh,
                            cfg: PoseGraphConfig = PoseGraphConfig()
                            ) -> PoseGraphResult:
    """Pose-graph optimisation with edges sharded over the "map" axis.

    g's edge arrays must already be padded to a multiple of the axis size
    (use `partition_edges`); poses are replicated in and out.
    """

    @jax.jit
    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(), P("map"), P("map"), P("map"), P("map"),
                       P("map")),
             out_specs=P(), check_vma=False)
    def run(poses_r, poses_t, ei, ej, mr, mt, wt):
        local = PoseGraph(poses_r=poses_r, poses_t=poses_t, edge_i=ei,
                          edge_j=ej, meas_r=mr, meas_t=mt, weight=wt)
        return lm_loop(local, cfg, axis_name="map")

    return run(g.poses_r, g.poses_t, g.edge_i, g.edge_j,
               g.meas_r, g.meas_t, g.weight)
