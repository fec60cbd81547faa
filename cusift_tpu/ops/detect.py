"""DoG extrema detection, subpixel refinement, static compaction.

Reference analog: the ``FindPointsMulti`` CUDA kernel (SURVEY.md C8):
thread-per-pixel 26-neighbour extremum test, contrast/edge rejection, 3-D
quadratic refinement, atomic append.  Design (SURVEY.md §2.2, §7):

* the 26-neighbour test is one `lax.reduce_window` max/min over the
  [S+2, H, W] DoG stack — dense elementwise work, no divergence;
* candidates are compacted with `top_k` on |DoG| into a static
  per-octave budget (no atomics, no host sync);
* quadratic refinement runs only on the compacted candidates: each
  refinement iteration is ONE batched (3,3,3)-slice gather over all
  candidates plus closed-form batched 3x3 solves — no per-candidate
  dynamic slicing and no dense derivative materialisation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..config import SiftConfig
from .keypoints import Keypoints, concat_keypoints, topk_keypoints
from .mat3 import solve3
from .pyramid import Octave


def _extrema_mask(dog: jnp.ndarray, prefilter: float) -> jnp.ndarray:
    """[S, H, W] bool: strict 26-neighbour extrema of dog[1:S+1].

    dog is the full [S+2, H, W] stack; detection levels are 1..S.
    """
    # Separable 3x3x3 window max/min via shifted elementwise ops — three
    # 3-tap passes fuse into one elementwise loop, where a 3-D
    # reduce_window does not.
    def _win(x, op):
        x = op(op(x[:-2], x[1:-1]), x[2:])                     # scale axis
        x = op(op(x[:, :-2], x[:, 1:-1]), x[:, 2:])            # rows
        x = op(op(x[:, :, :-2], x[:, :, 1:-1]), x[:, :, 2:])   # cols
        return x

    wmax = _win(dog, jnp.maximum)
    wmin = _win(dog, jnp.minimum)
    centre = dog[1:-1, 1:-1, 1:-1]
    # centre equals window max/min iff it is >= / <= all 26 neighbours; break
    # plateau ties by requiring the value to also clear the prefilter.
    is_max = (centre >= wmax) & (centre > prefilter)
    is_min = (centre <= wmin) & (centre < -prefilter)
    mask = is_max | is_min
    return jnp.pad(mask, ((0, 0), (1, 1), (1, 1)))  # [S, H, W]


def _gather_cubes(dog: jnp.ndarray, lvl, y, x) -> jnp.ndarray:
    """One batched gather of 3x3x3 DoG neighbourhoods: [K, 3, 3, 3].

    Nine minor-dimension (1, 1, 3)-slice gathers (one per (dz, dy) of the
    stencil): a contiguous 3-wide slice costs about one index, so this
    fetches a cube with 9K indices where a 27-static-offset flat take
    pays 27K.  A dense 10-channel derivative precompute would instead
    write ~250 MB per upscaled octave.  (lvl, y, x) are pre-clipped to
    the stack interior, so every slice is in range.
    """
    k = lvl.shape[0]
    dn = lax.GatherDimensionNumbers(offset_dims=(1,),
                                    collapsed_slice_dims=(0, 1),
                                    start_index_map=(0, 1, 2))
    rows = []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            starts = jnp.stack([lvl + dz, y + dy, x - 1], -1)  # [K, 3]
            rows.append(lax.gather(dog, starts, dn, slice_sizes=(1, 1, 3),
                                   mode=lax.GatherScatterMode.CLIP))
    return jnp.stack(rows, 1).reshape(k, 3, 3, 3)


def _solve_at(dog, lvl, y, x):
    """Quadratic fit at integer locations: (v, g [K,3], H [K,3,3], off, ok).

    Derivative stencils match the reference's in-thread finite differences
    (``FindPointsMulti``); all arithmetic is [K]-batched VPU math.
    """
    c = _gather_cubes(dog, lvl, y, x)
    v = c[:, 1, 1, 1]
    dx = 0.5 * (c[:, 1, 1, 2] - c[:, 1, 1, 0])
    dy = 0.5 * (c[:, 1, 2, 1] - c[:, 1, 0, 1])
    ds = 0.5 * (c[:, 2, 1, 1] - c[:, 0, 1, 1])
    dxx = c[:, 1, 1, 2] - 2 * v + c[:, 1, 1, 0]
    dyy = c[:, 1, 2, 1] - 2 * v + c[:, 1, 0, 1]
    dss = c[:, 2, 1, 1] - 2 * v + c[:, 0, 1, 1]
    dxy = 0.25 * (c[:, 1, 2, 2] - c[:, 1, 2, 0] - c[:, 1, 0, 2] + c[:, 1, 0, 0])
    dxs = 0.25 * (c[:, 2, 1, 2] - c[:, 2, 1, 0] - c[:, 0, 1, 2] + c[:, 0, 1, 0])
    dys = 0.25 * (c[:, 2, 2, 1] - c[:, 2, 0, 1] - c[:, 0, 2, 1] + c[:, 0, 0, 1])
    g = jnp.stack([dx, dy, ds], -1)
    row0 = jnp.stack([dxx, dxy, dxs], -1)
    row1 = jnp.stack([dxy, dyy, dys], -1)
    row2 = jnp.stack([dxs, dys, dss], -1)
    H = jnp.stack([row0, row1, row2], -2)                      # [K, 3, 3]
    off, ok = solve3(H, -g)
    return v, g, H, off, ok


def _refine_batch(dog: jnp.ndarray, lvl, y, x, cfg: SiftConfig,
                  shape: tuple):
    """Iteratively refine all candidates at once; arrays are [K]-shaped."""
    s_levels, h, w = shape

    def step(carry, _):
        lvl, y, x, _ = carry
        _, _, _, off, ok = _solve_at(dog, lvl, y, x)
        # move the integer location while the offset escapes the pixel
        mx = jnp.round(off[:, 0]).astype(jnp.int32)
        my = jnp.round(off[:, 1]).astype(jnp.int32)
        ms = jnp.round(off[:, 2]).astype(jnp.int32)
        x2 = jnp.clip(x + mx, 1, w - 2)
        y2 = jnp.clip(y + my, 1, h - 2)
        l2 = jnp.clip(lvl + ms, 1, s_levels - 2)
        return (l2, y2, x2, ok), None

    init = (lvl, y, x, jnp.ones_like(lvl, dtype=bool))
    (lvl, y, x, ok), _ = lax.scan(step, init, None, length=cfg.refine_iters)
    # recompute at the final integer location for consistent derivatives
    v, g, H, off, ok2 = _solve_at(dog, lvl, y, x)
    contrast = v + 0.5 * jnp.sum(g * off, -1)

    converged = jnp.all(jnp.abs(off) < 1.0, -1) & ok & ok2
    # 2x2 spatial-Hessian edge rejection
    tr = H[:, 0, 0] + H[:, 1, 1]
    det2 = H[:, 0, 0] * H[:, 1, 1] - H[:, 0, 1] * H[:, 0, 1]
    r = cfg.edge_thresh
    edge_ok = (det2 > 0) & (tr * tr * r < (r + 1) ** 2 * det2)
    edgeness = jnp.where(det2 > 0, tr * tr / jnp.maximum(det2, 1e-12), jnp.inf)

    contrast_ok = jnp.abs(contrast) * cfg.scales_per_octave >= cfg.contrast_thresh
    xo = x.astype(jnp.float32) + off[:, 0]
    yo = y.astype(jnp.float32) + off[:, 1]
    so = lvl.astype(jnp.float32) + off[:, 2]
    in_bounds = ((xo >= cfg.border) & (xo < w - cfg.border) &
                 (yo >= cfg.border) & (yo < h - cfg.border))
    valid = converged & edge_ok & contrast_ok & in_bounds
    return xo, yo, so, lvl, contrast, edgeness, valid


def extrema_score(dog: jnp.ndarray, cfg: SiftConfig) -> jnp.ndarray:
    """[S, H, W] candidate score: |DoG| at prefiltered extrema, else -inf."""
    prefilter = 0.5 * cfg.contrast_thresh / cfg.scales_per_octave
    mask = _extrema_mask(dog, prefilter)                       # [S, H, W]
    return jnp.where(mask, jnp.abs(dog[1:-1]), -jnp.inf)


def detect_octave(oct_: Octave, octave_idx: int, cfg: SiftConfig) -> Keypoints:
    """All keypoints of one octave, compacted to cfg.kpt_budget(octave)."""
    return detect_from_score(oct_.dog, extrema_score(oct_.dog, cfg),
                             octave_idx, cfg)


def detect_from_score(dog: jnp.ndarray, score: jnp.ndarray,
                      octave_idx: int, cfg: SiftConfig) -> Keypoints:
    """Compaction + refinement from a precomputed extrema score.

    `score` comes from `extrema_score`.
    """
    s, h, w = dog.shape
    k = cfg.kpt_budget(octave_idx)
    if cfg.approx_topk:
        # approximate top-k (recall target 0.95) where the backend
        # implements it; exact top-k costs a full sort of S*H*W scores
        # per octave.  95% recall only perturbs which *weak* candidates
        # fill the tail of the static budget.
        flat_score, flat_idx = lax.approx_max_k(score.reshape(-1), k,
                                                recall_target=0.95)
    else:
        flat_score, flat_idx = lax.top_k(score.reshape(-1), k)
    lvl = (flat_idx // (h * w)).astype(jnp.int32) + 1          # DoG level 1..S
    rem = flat_idx % (h * w)
    y = (rem // w).astype(jnp.int32)
    x = (rem % w).astype(jnp.int32)
    cand_valid = jnp.isfinite(flat_score)
    # keep gathers in-bounds for invalid lanes
    y = jnp.clip(y, 1, h - 2)
    x = jnp.clip(x, 1, w - 2)

    xo, yo, so, lvl_f, contrast, edgeness, valid = _refine_batch(
        dog, lvl, y, x, cfg, dog.shape)
    valid = valid & cand_valid

    # octave-local -> base-image coordinates
    scale_mult = float(2 ** octave_idx) * (0.5 if cfg.upscale else 1.0)
    sigma = cfg.sigma0 * (2.0 ** (so / cfg.scales_per_octave)) * scale_mult
    return Keypoints(
        x=xo * scale_mult, y=yo * scale_mult, sigma=sigma,
        response=contrast, edgeness=edgeness,
        octave=jnp.full_like(lvl_f, octave_idx),
        level=lvl_f, xo=xo, yo=yo, so=so, valid=valid,
    )


def detect(octaves: list[Octave], cfg: SiftConfig) -> Keypoints:
    """Keypoints over all octaves, compacted to the global cfg.max_kpts."""
    per_oct = [detect_octave(o, i, cfg) for i, o in enumerate(octaves)]
    return topk_keypoints(concat_keypoints(per_oct), cfg.max_kpts)
