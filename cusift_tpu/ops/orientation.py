"""Orientation assignment via fixed-grid gradient histograms.

Reference analog: ``ComputeOrientations`` (SURVEY.md C9): block-per-keypoint,
32-bin histogram of Gaussian-weighted gradient directions, dominant peak plus
secondary peaks >= 80% emit up to two orientations via atomic keypoint
duplication.  Here every keypoint samples a *fixed* G x G grid over
its circular support (batched bilinear gather), soft-assigns angles to a
36-bin histogram with a vectorised scatter-add, and the "duplication" becomes
a static second orientation slot per keypoint with its own validity mask —
no atomics, no divergence (SURVEY.md §2.2 row 3).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..config import SiftConfig
from .keypoints import Keypoints
from .sampling import sample_grad_grid


def _grid_offsets(g: int) -> np.ndarray:
    """Unit-square sample offsets in [-1, 1], cell centres; static."""
    c = (np.arange(g, dtype=np.float32) + 0.5) / g * 2.0 - 1.0
    vy, vx = np.meshgrid(c, c, indexing="ij")
    return np.stack([vy.ravel(), vx.ravel()], axis=-1)  # [g*g, 2]


def _smooth_hist(h: jnp.ndarray) -> jnp.ndarray:
    """Circular [1,4,6,4,1]/16 smoothing along the last axis (cv2.SIFT)."""
    r = (jnp.roll(h, 1, -1) + jnp.roll(h, -1, -1))
    r2 = (jnp.roll(h, 2, -1) + jnp.roll(h, -2, -1))
    return (6.0 * h + 4.0 * r + r2) / 16.0


def orientation_histograms(gauss: jnp.ndarray, kps: Keypoints,
                           cfg: SiftConfig,
                           level_base: int = 0) -> jnp.ndarray:
    """[K, ori_bins] gradient-direction histograms (octave-local sampling).

    gauss: [L, H, W] blurred levels of this octave (gradients are taken by
    the sampler); plane i corresponds to Gaussian level i + level_base
    (keypoints only live on DoG levels 1..S, so callers skip the rest).
    """
    g = cfg.ori_grid
    nb = cfg.ori_bins
    offs = jnp.asarray(_grid_offsets(g))                       # [S, 2]
    sigma_oct = cfg.sigma0 * 2.0 ** (kps.so / cfg.scales_per_octave)  # [K]
    radius = cfg.ori_radius_factor * sigma_oct                 # [K]
    # the grid is axis-aligned and square: its S = g*g samples factor
    # into g distinct rows x g distinct cols (row-major, matching
    # _grid_offsets' meshgrid-ij ravel)
    c1d = jnp.asarray((np.arange(g, dtype=np.float32) + 0.5) / g * 2.0 - 1.0)
    ys_rows = kps.yo[:, None] + radius[:, None] * c1d[None, :]  # [K, g]
    xs_cols = kps.xo[:, None] + radius[:, None] * c1d[None, :]
    lvl = jnp.clip(kps.level - level_base, 0, gauss.shape[0] - 1)

    # Gaussian weight over the circular support; r in units of sigma.
    r2 = (offs[None, :, 0] ** 2 + offs[None, :, 1] ** 2) * (cfg.ori_radius_factor ** 2)
    wgt = jnp.exp(-r2 / (2.0 * cfg.ori_sigma_factor ** 2))
    wgt = wgt * (r2 <= cfg.ori_radius_factor ** 2)             # circular mask

    dx, dy, inb = sample_grad_grid(gauss, lvl, ys_rows, xs_cols)
    mag = jnp.sqrt(dx * dx + dy * dy)
    ang = jnp.arctan2(dy, dx)                                  # [-pi, pi]
    w = mag * wgt * inb * kps.valid[:, None]                   # [K, S]

    # Soft 2-bin assignment as a broadcast contraction: the linear-interp
    # weight of sample s toward bin b is max(0, 1 - circ_dist(fbin, b)) —
    # elementwise math, no scatters and no eye[...] gathers.  The
    # contraction runs at HIGHEST (full f32): a TF32 pass would round the
    # bin weights to ~1e-3 and shift the parabolic peak refinement.
    fbin = (ang / (2.0 * jnp.pi) * nb) % nb                    # [K, S]
    bins = jnp.arange(nb, dtype=w.dtype)
    dist = jnp.abs(fbin[..., None] - bins)                     # [K, S, nb]
    dist = jnp.minimum(dist, nb - dist)                        # circular
    onehot = jnp.maximum(0.0, 1.0 - dist)
    hist = jnp.einsum("ks,ksb->kb", w, onehot,
                      precision=lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32)
    return _smooth_hist(hist)


def dominant_orientations(hist: jnp.ndarray, cfg: SiftConfig):
    """Up to cfg.max_orientations angles per keypoint from the histogram.

    Returns (theta [K, M], ok [K, M]): slot 0 is the global peak; later
    slots are the next-best local peaks >= peak_ratio * max, at least two
    bins away from earlier picks.  Parabolic sub-bin refinement throughout.
    """
    nb = cfg.ori_bins
    k = hist.shape[0]
    left = jnp.roll(hist, 1, -1)
    right = jnp.roll(hist, -1, -1)
    is_peak = (hist > left) & (hist > right)
    hmax = jnp.max(hist, axis=-1, keepdims=True)

    def refine(b):  # b: [K] int
        hc = jnp.take_along_axis(hist, b[:, None], -1)[:, 0]
        hl = jnp.take_along_axis(left, b[:, None], -1)[:, 0]   # hist[b-1]
        hr = jnp.take_along_axis(right, b[:, None], -1)[:, 0]  # hist[b+1]
        denom = hl - 2 * hc + hr
        delta = jnp.where(jnp.abs(denom) > 1e-12,
                          0.5 * (hl - hr) / jnp.where(jnp.abs(denom) > 1e-12, denom, 1.0),
                          0.0)
        delta = jnp.clip(delta, -0.5, 0.5)
        return ((b + delta) / nb * 2.0 * jnp.pi) % (2.0 * jnp.pi)

    thetas, oks = [], []
    score = jnp.where(is_peak, hist, -jnp.inf)
    bins = jnp.arange(nb)[None, :]
    for m in range(cfg.max_orientations):
        b = jnp.argmax(score, axis=-1)
        val = jnp.take_along_axis(score, b[:, None], -1)[:, 0]
        ok = jnp.isfinite(val) & (val >= cfg.ori_peak_ratio * hmax[:, 0]) & (hmax[:, 0] > 0)
        thetas.append(refine(b))
        oks.append(ok)
        # suppress +-1 bins around the chosen peak (circular)
        d = jnp.abs((bins - b[:, None] + nb // 2) % nb - nb // 2)
        score = jnp.where(d <= 1, -jnp.inf, score)
    return jnp.stack(thetas, -1), jnp.stack(oks, -1)
