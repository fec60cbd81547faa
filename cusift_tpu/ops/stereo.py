"""Rectified-stereo feature depth (KITTI-style rigs).

New surface relative to the reference (SURVEY.md §0): cuSIFT ships
extract/match primitives; a stereo rig turns one descriptor match per
feature into METRIC depth (z = fx * b / disparity), which removes the
monocular scale ambiguity entirely — the depth then feeds the exact
RGB-D tracking/keyframe/BA machinery of models/slam.py.

Design: the left-right match rides the same matcher as
every other match in the engine (ops/match.py); the epipolar constraints
of a RECTIFIED pair (same row, positive disparity) are cheap post-hoc
masks rather than a search-window restriction — a [N, M] matmul over
static capacities beats a banded gather on this hardware, and the row
gate rejects the few cross-row winners after the fact.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import MatchConfig
from .match import match


@partial(jax.jit, static_argnames=("match_cfg",))
def stereo_depth(desc_l, valid_l, x_l, y_l, desc_r, valid_r, x_r, y_r,
                 fx, baseline, match_cfg: MatchConfig = MatchConfig(),
                 row_tol: float = 1.5, min_disp: float = 0.75,
                 min_depth: float = 0.2):
    """Per-left-slot metric depth from one rectified stereo pair.

    Returns (depth [N], ok [N]): depth 0 where no admissible right match
    exists.  Gates: ratio-test match, |row difference| <= row_tol px
    (rectified epipolar), disparity above min_disp px (distant points
    carry no stereo information) and below fx*b/min_depth (a gross
    mismatch would otherwise produce an absurdly near point).
    """
    m = match(desc_l, valid_l, desc_r, valid_r, match_cfg)
    xr = x_r[m.idx]
    yr = y_r[m.idx]
    disp = x_l - xr
    fb = fx * baseline
    ok = (m.ok & valid_l
          & (jnp.abs(y_l - yr) <= row_tol)
          & (disp > min_disp)
          & (disp < fb / min_depth))
    depth = jnp.where(ok, fb / jnp.maximum(disp, 1e-6), 0.0)
    return depth, ok
