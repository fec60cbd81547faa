"""Fused descriptor matcher for Hopper: similarity tiles + running top-2.

Reference analog: the shared-memory tiled GEMM + reduction in
``MatchSiftPoints*`` / ``FindMaxCorr`` (SURVEY.md C12).  The XLA path in
ops/match.py writes the [N, M] f32 similarity matrix to device memory and
reads it back twice (max/argmax, then the masked second max).  Here each
block owns ``BN`` query rows of one pair, keeps its [BN, 128] query tile
resident, and walks B in ``BM``-column tiles: one tensor-core product per
tile, reduced straight into a running (best, best index, second best) in
registers.  Only [P, N]-sized results reach device memory.

Route: Pallas through Triton (``backend="triton"``).  The grid is
(pair, row block), so the 7 consecutive pairs of an 8-frame batch fill the
card's 132 SMs together where one pair's 48 row blocks at N = 6144 would
not; ops/match.py sends smaller batches to XLA.  Tiles of 128 x 128 with
8 warps and 2 stages were the fastest of five settings timed on an H100
(docs/kernels.md).

Precision: f32 operands with TF32 products (``Precision.HIGH``) and f32
accumulation — the same setting as the XLA path, so the two agree up to
summation order.

Nothing differentiates through matching, so there is no gradient rule.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BN = 128      # query rows per block
BM = 128      # B columns per inner-loop tile
NUM_WARPS = 8
NUM_STAGES = 2


def _top2_kernel(a_ref, b_ref, vb_ref, s1_ref, s2_ref, i1_ref, *,
                 n_tiles: int):
    a = a_ref[...]                                         # [BN, D]

    def body(j, carry):
        s1, i1, s2 = carry
        cols = pl.ds(j * BM, BM)
        b = b_ref[cols, :]                                 # [BM, D]
        vb = vb_ref[cols]                                  # [BM]
        sim = pl.dot(a, b, trans_b=True, precision=lax.Precision.HIGH)
        sim = jnp.where(vb[None, :] > 0, sim, -jnp.inf)    # [BN, BM]
        col = j * BM + lax.broadcasted_iota(jnp.int32, (BN, BM), 1)
        t1 = jnp.max(sim, axis=1)
        # first column attaining the tile max (argmax tie order)
        ti = jnp.min(jnp.where(sim == t1[:, None], col, jnp.int32(2**30)),
                     axis=1)
        t2 = jnp.max(jnp.where(col == ti[:, None], -jnp.inf, sim), axis=1)
        # strict >: an earlier tile keeps a tie, as argmax keeps the first
        better = t1 > s1
        s2 = jnp.where(better, jnp.maximum(s1, t2), jnp.maximum(s2, t1))
        i1 = jnp.where(better, ti, i1)
        s1 = jnp.maximum(s1, t1)
        return s1, i1, s2

    init = (jnp.full((BN,), -jnp.inf, jnp.float32),
            jnp.zeros((BN,), jnp.int32),
            jnp.full((BN,), -jnp.inf, jnp.float32))
    s1, i1, s2 = lax.fori_loop(0, n_tiles, body, init)
    s1_ref[...] = s1
    s2_ref[...] = s2
    i1_ref[...] = i1


@partial(jax.jit, static_argnames=("interpret",))
def top2(desc_a: jnp.ndarray, desc_b: jnp.ndarray, valid_b: jnp.ndarray, *,
         interpret: bool = False):
    """Best score, second-best score and best index of each row of A.

    desc_a [P, N, D], desc_b [P, M, D] (f32, D a power of two), valid_b
    [P, M].  Rows of A are padded to a multiple of ``BN`` and columns of B
    to a multiple of ``BM``; padded columns are masked like invalid ones.
    Returns (s1, s2, i1), each [P, N].  ``interpret`` runs the kernel on
    the CPU (tests only).
    """
    p, n, d = desc_a.shape
    m = desc_b.shape[1]
    pad_n, pad_m = (-n) % BN, (-m) % BM
    a = jnp.pad(desc_a.astype(jnp.float32), ((0, 0), (0, pad_n), (0, 0)))
    b = jnp.pad(desc_b.astype(jnp.float32), ((0, 0), (0, pad_m), (0, 0)))
    vb = jnp.pad(valid_b.astype(jnp.int32), ((0, 0), (0, pad_m)))
    np_, mp = n + pad_n, m + pad_m
    row = pl.BlockSpec((None, BN), lambda q, i: (q, i))
    s1, s2, i1 = pl.pallas_call(
        partial(_top2_kernel, n_tiles=mp // BM),
        grid=(p, np_ // BN),
        in_specs=[
            pl.BlockSpec((None, BN, d), lambda q, i: (q, i, 0)),
            pl.BlockSpec((None, mp, d), lambda q, i: (q, 0, 0)),
            pl.BlockSpec((None, mp), lambda q, i: (q, 0)),
        ],
        out_specs=[row, row, row],
        out_shape=[jax.ShapeDtypeStruct((p, np_), jnp.float32),
                   jax.ShapeDtypeStruct((p, np_), jnp.float32),
                   jax.ShapeDtypeStruct((p, np_), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="sift_match_top2",
    )(a, b, vb)
    return s1[:, :n], s2[:, :n], i1[:, :n]
