"""Brute-force descriptor matching as one matmul plus a top-2 per row.

Reference analog: ``MatchSiftData`` (SURVEY.md C12, hot loop #3) — a
hand-rolled shared-memory tiled GEMM over 128-d descriptors plus per-row
best/second-best reduction.  Here it is ``A @ B.T`` followed by two max
passes.  On the GPU, large pair batches go to the fused Pallas kernel in
``ops/pallas/matcher.py``, which never writes the [N, M] similarity matrix
to device memory.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import MatchConfig

# TF32 products with f32 accumulation on the GPU's tensor cores (plain f32
# on the CPU).  Correlations of unit descriptors then carry ~1e-4 absolute
# error, far below the gaps the 0.8 ratio test separates.
MATCH_PRECISION = lax.Precision.HIGH


class Matches(NamedTuple):
    """Per-row-of-A match results (reference: fields written into SiftData A)."""

    idx: jnp.ndarray    # [N] int32 best match in B
    dist: jnp.ndarray   # [N] L2 distance of best match ("match_error")
    score: jnp.ndarray  # [N] best correlation (dot product)
    ratio: jnp.ndarray  # [N] d1/d2 ambiguity
    ok: jnp.ndarray     # [N] passed validity + ratio test (+ cross-check)


# "auto" takes the fused kernel for pair batches of at least this many
# query rows (pairs x slots).  Every block of 128 rows walks all of B, so
# below ~64 blocks the kernel's time stays at one block's walk while XLA's
# keeps falling: on an H100 the two tie at 6-7 k rows and XLA wins at
# 4 k and fewer (chip_smoke.py phase 3, docs/kernels.md).
KERNEL_MIN_ROWS = 8192


def resolve_backend(cfg: MatchConfig, rows: int) -> str:
    """The backend for `rows` query rows (pairs x slots of A).

    "auto" picks the fused kernel on the GPU for large pair batches and
    XLA otherwise.
    """
    if cfg.backend != "auto":
        return cfg.backend
    if jax.default_backend() == "gpu" and rows >= KERNEL_MIN_ROWS:
        return "triton"
    return "xla"


def xla_top2(a, b, valid_b, precision=MATCH_PRECISION):
    """(s1, s2, i1) of [P, N, D] against [P, M, D] through the full matrix.

    The plain reference of the fused kernel (ops/pallas/matcher.py:top2).
    """
    sim = jnp.einsum("pnd,pmd->pnm", a, b, precision=precision,
                     preferred_element_type=jnp.float32)
    sim = jnp.where(valid_b[:, None, :], sim, -jnp.inf)      # mask dead cols
    # max/argmax plus a masked second max: `lax.top_k` would sort each row
    s1 = jnp.max(sim, axis=-1)
    i1 = jnp.argmax(sim, axis=-1).astype(jnp.int32)
    cols = lax.broadcasted_iota(jnp.int32, sim.shape, 2)
    s2 = jnp.max(jnp.where(cols == i1[..., None], -jnp.inf, sim), axis=-1)
    return s1, s2, i1


@partial(jax.jit, static_argnames=("cfg", "interpret"))
def match(desc_a: jnp.ndarray, valid_a: jnp.ndarray,
          desc_b: jnp.ndarray, valid_b: jnp.ndarray,
          cfg: MatchConfig = MatchConfig(),
          interpret: bool = False) -> Matches:
    """Ratio-test matching of [N, 128] against [M, 128] unit descriptors.

    A leading pair axis ([P, N, 128] against [P, M, 128]) matches P pairs
    in one call; every output then carries the same leading axis.
    ``interpret`` runs the Pallas kernel on the CPU (tests only).
    """
    single = desc_a.ndim == 2
    if single:
        desc_a, valid_a, desc_b, valid_b = (
            x[None] for x in (desc_a, valid_a, desc_b, valid_b))
    n = desc_a.shape[1]
    if resolve_backend(cfg, desc_a.shape[0] * n) == "triton":
        from .pallas.matcher import top2
        s1, s2, i1 = top2(desc_a, desc_b, valid_b, interpret=interpret)
        if cfg.cross_check:
            _, _, best_for_b = top2(desc_b, desc_a, valid_a,
                                    interpret=interpret)
    else:
        s1, s2, i1 = xla_top2(desc_a, desc_b, valid_b)
        if cfg.cross_check:
            _, _, best_for_b = xla_top2(desc_b, desc_a, valid_a)

    # unit vectors: d^2 = 2 - 2 * <a, b>.  Clamp the correlations to the
    # valid [-1, 1] range first: masked lanes carry -inf, and inf/inf in
    # the ratio would be a NaN (flagged by jax_debug_nans) even though the
    # ok gate discards those lanes.
    d1 = jnp.sqrt(jnp.maximum(2.0 - 2.0 * jnp.clip(s1, -1.0, 1.0), 0.0))
    d2 = jnp.sqrt(jnp.maximum(2.0 - 2.0 * jnp.clip(s2, -1.0, 1.0), 1e-12))
    ratio = d1 / d2
    # isfinite(s2): with a single valid candidate in B the second-best is
    # -inf, d2 = inf and ratio = 0 — the test would pass vacuously for
    # every query row
    ok = (valid_a & jnp.isfinite(s1) & jnp.isfinite(s2)
          & (ratio < cfg.ratio_thresh) & (s1 > cfg.min_score))
    if cfg.cross_check:
        back = jnp.take_along_axis(best_for_b, i1, axis=1)
        ok = ok & (back == jnp.arange(n)[None, :])
    out = Matches(idx=i1, dist=d1, score=s1, ratio=ratio, ok=ok)
    return jax.tree.map(lambda x: x[0], out) if single else out
