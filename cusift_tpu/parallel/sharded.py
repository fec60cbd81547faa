"""Sharded feature pipelines (SURVEY.md §2.4 D2/D3).

Frame-parallel extraction: a batch of frames is sharded over the mesh's
"frames" axis with `shard_map`; each device runs the full single-frame
extract on its shard (embarrassingly parallel — the DP analog).  Matching
against a keyframe database shards the database over "map" (the TP analog):
each device scores its slice of keyframes with one matmul and an
`argmax`-over-`psum`-style reduction picks the winner.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import MatchConfig, SiftConfig
from ..models.sift import SiftFeatures, extract


def extract_frames(imgs: jnp.ndarray, mesh: Mesh,
                   cfg: SiftConfig = SiftConfig()) -> SiftFeatures:
    """Extract features for [B, H, W] frames sharded over "frames".

    B must be divisible by the frames-axis size.  Output arrays keep the
    leading B axis (sharded the same way).
    """

    @jax.jit
    @partial(shard_map, mesh=mesh, in_specs=P("frames"),
             out_specs=P("frames"), check_vma=False)
    def run(local_imgs):
        return jax.vmap(lambda im: extract(im, cfg))(local_imgs)

    return run(imgs)


def retrieval_scores(query_desc: jnp.ndarray, query_valid: jnp.ndarray,
                     db_desc: jnp.ndarray, db_valid: jnp.ndarray,
                     mesh: Mesh) -> jnp.ndarray:
    """Loop-closure retrieval: match-count score of a query against a
    keyframe database sharded over "map".

    query_desc [N, 128]; db_desc [KF, M, 128] -> scores [KF]: the summed
    best-correlation mass per keyframe (cheap bag-of-features proxy; the
    geometric verification happens on the winner only).
    """

    @jax.jit
    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(), P(None, "map"), P(None, "map")),
             out_specs=P(), check_vma=False)
    def run(q, qv, db, dbv):
        # db local shard: [KF, M_local, 128]
        sim = jnp.einsum("nd,kmd->knm", q, db,
                         preferred_element_type=jnp.float32)
        sim = jnp.where(dbv[:, None, :], sim, -jnp.inf)
        best = jnp.max(sim, axis=-1)                       # [KF, N]
        best = jnp.where(qv[None, :] & jnp.isfinite(best), best, 0.0)
        # partial max over the sharded M axis -> combine with psum of
        # per-shard sums is wrong for max; instead all-gather via psum of
        # one-hot... simplest correct reduction: pmax over lanes then mean.
        best = jax.lax.pmax(best, "map")                   # [KF, N]
        return jnp.sum(best, axis=-1) / jnp.maximum(jnp.sum(qv), 1.0)

    return run(query_desc, query_valid, db_desc, db_valid)


def match_pairs_sharded(desc_a: jnp.ndarray, valid_a: jnp.ndarray,
                        desc_b: jnp.ndarray, valid_b: jnp.ndarray,
                        mesh: Mesh, cfg: MatchConfig = MatchConfig()):
    """Batch of descriptor-set pairs matched in parallel over "frames".

    desc_a, desc_b: [B, N, 128]; returns the Matches struct with leading B.
    """
    from ..ops.match import match

    @jax.jit
    @partial(shard_map, mesh=mesh, in_specs=P("frames"),
             out_specs=P("frames"), check_vma=False)
    def run(da, va, db, vb):
        return jax.vmap(lambda a, av, b, bv: match(a, av, b, bv, cfg))(da, va, db, vb)

    return run(desc_a, valid_a, desc_b, valid_b)
