"""128-d SIFT descriptors as fixed-grid sampling + one-hot matmuls.

Reference analog: ``ExtractSiftDescriptors`` (SURVEY.md C10, hot loop #2):
warp-parallel 16x16 rotated sampling with texture fetches, trilinear binning
into 4x4 cells x 8 orientation bins, normalize -> clip 0.2 -> renormalize.

Design (SURVEY.md §2.2 row 3, §7 "turn gathers into matmuls"): each
(keypoint, orientation) slot samples a fixed G x G grid directly in the
*rotated descriptor frame*, so the spatial trilinear weights are a static
[G^2, 16] matrix known at trace time.  Only the 8-way orientation binning is
data-dependent; the descriptor reduces to one einsum
``[K, G^2, 8] x [G^2, 16] -> [K, 16, 8]``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..config import SiftConfig
from .keypoints import Keypoints
from .sampling import sample_grad_pair


class Slots(NamedTuple):
    """Compacted (keypoint, orientation) slots of one octave, [N]-shaped.

    The reference duplicates keypoints per extra orientation via atomic
    append (SURVEY.md C9); here slots are compacted with top-k on validity
    so descriptor sampling never wastes gather bandwidth on dead lanes.
    """

    x: jnp.ndarray
    y: jnp.ndarray
    sigma: jnp.ndarray
    response: jnp.ndarray
    edgeness: jnp.ndarray
    octave: jnp.ndarray
    level: jnp.ndarray
    xo: jnp.ndarray
    yo: jnp.ndarray
    so: jnp.ndarray
    theta: jnp.ndarray
    valid: jnp.ndarray


def compact_slots(kps: Keypoints, theta: jnp.ndarray, ok: jnp.ndarray,
                  n_slots: int) -> Slots:
    """Flatten [K, M] orientation slots and keep the n_slots best-valid."""
    k, m = theta.shape
    rep = lambda a: jnp.repeat(a, m, axis=0)
    valid = (ok & kps.valid[:, None]).reshape(-1)
    resp = rep(kps.response)
    score = jnp.where(valid, 1.0 + jnp.abs(resp), 0.0)
    _, idx = jax.lax.top_k(score, n_slots)
    take = lambda a: a[idx]
    return Slots(
        x=take(rep(kps.x)), y=take(rep(kps.y)), sigma=take(rep(kps.sigma)),
        response=take(resp), edgeness=take(rep(kps.edgeness)),
        octave=take(rep(kps.octave)), level=take(rep(kps.level)),
        xo=take(rep(kps.xo)), yo=take(rep(kps.yo)), so=take(rep(kps.so)),
        theta=take(theta.reshape(-1)), valid=take(valid) & (take(score) > 0),
    )


def _spatial_weights(g: int, d: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static grid geometry.

    Returns (cell_coords [g*g, 2], W_spatial [g*g, d*d], gauss [g*g]).
    Cell coordinates u, v span [-d/2, d/2]; cell centres sit at
    -d/2 + 0.5, ..., d/2 - 0.5.  W_spatial holds the bilinear weight of each
    sample toward each of the d*d cells.
    """
    c = (np.arange(g, dtype=np.float32) + 0.5) / g * d - d / 2.0  # [-d/2, d/2]
    vv, uu = np.meshgrid(c, c, indexing="ij")                     # v=row, u=col
    coords = np.stack([vv.ravel(), uu.ravel()], -1)               # [g*g, 2]
    centres = np.arange(d, dtype=np.float32) - d / 2.0 + 0.5      # [d]
    wv = np.maximum(0.0, 1.0 - np.abs(coords[:, 0:1] - centres[None, :]))  # [g*g, d]
    wu = np.maximum(0.0, 1.0 - np.abs(coords[:, 1:2] - centres[None, :]))
    w_spatial = (wv[:, :, None] * wu[:, None, :]).reshape(g * g, d * d)
    gauss = np.exp(-(coords ** 2).sum(-1) / (0.5 * d * d))        # sigma = d/2
    return coords.astype(np.float32), w_spatial.astype(np.float32), gauss.astype(np.float32)


def descriptors(gauss: jnp.ndarray, slots: Slots,
                cfg: SiftConfig, level_base: int = 0):
    """Descriptors for compacted slots of one octave.

    gauss: [L, H, W] blurred levels (gradients taken by the sampler);
    plane i is Gaussian level i + level_base.
    Returns (desc [N, 128], slot_valid [N]).
    """
    g, d, nb = cfg.desc_grid, cfg.desc_width, cfg.desc_bins
    coords, w_spatial, gw = map(jnp.asarray, _spatial_weights(g, d))

    th = slots.theta
    slot_valid = slots.valid
    xo, yo, so = slots.xo, slots.yo, slots.so
    lvl = jnp.clip(slots.level - level_base, 0, gauss.shape[0] - 1)
    n = th.shape[0]

    sigma_oct = cfg.sigma0 * 2.0 ** (so / cfg.scales_per_octave)
    cell_w = cfg.desc_scale_factor * sigma_oct                 # px per cell
    ct, st = jnp.cos(th), jnp.sin(th)
    # rotate descriptor-frame coords (v=row, u=col) into the image frame
    u = coords[None, :, 1] * cell_w[:, None]                   # [KM, S]
    v = coords[None, :, 0] * cell_w[:, None]
    xs = xo[:, None] + u * ct[:, None] - v * st[:, None]
    ys = yo[:, None] + u * st[:, None] + v * ct[:, None]

    dx, dy, inb = sample_grad_pair(gauss, lvl, ys, xs)
    mag = jnp.sqrt(dx * dx + dy * dy)
    # Gradient direction rotated into the keypoint frame.  Negated
    # (theta - grad) to match the classic descriptor's y-up angle
    # convention (image rows grow downward here); validated against
    # the cv2 oracle in tests/test_extract.py.
    ang = th[:, None] - jnp.arctan2(dy, dx)
    w = mag * gw[None, :] * inb                                # [KM, S]

    # Soft orientation binning as broadcast circular-distance weights
    # (2 non-zeros per sample; no eye[...] gathers).
    fbin = (ang / (2.0 * jnp.pi) * nb) % nb
    bins = jnp.arange(nb, dtype=w.dtype)
    dist = jnp.abs(fbin[..., None] - bins)                     # [N, S, nb]
    dist = jnp.minimum(dist, nb - dist)
    obin = jnp.maximum(0.0, 1.0 - dist)
    contrib = obin * w[..., None]

    # Contraction over samples: spatial cells x orientation bins, in full
    # f32 (HIGHEST) — the FLOPs are small, and TF32 products would put
    # ~1e-3 relative noise into every descriptor entry.
    desc = jnp.einsum("sc,ksb->kcb", w_spatial, contrib,
                      precision=lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32)      # [N, 16, 8]
    desc = desc.reshape(n, d * d * nb)

    # normalise -> clip -> renormalise (Lowe)
    norm = jnp.linalg.norm(desc, axis=-1, keepdims=True)
    desc = desc / jnp.maximum(norm, 1e-12)
    desc = jnp.minimum(desc, cfg.desc_clip)
    norm = jnp.linalg.norm(desc, axis=-1, keepdims=True)
    desc = desc / jnp.maximum(norm, 1e-12)
    return desc * slot_valid[:, None], slot_valid
