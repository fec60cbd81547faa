"""Batched bilinear sampling from pyramid level stacks.

Reference analog: CUDA texture-object bilinear fetches in
``ExtractSiftDescriptors`` / ``ComputeOrientations`` (SURVEY.md C9–C10).
Here the equivalent is a batched gather of the four corner pixels plus
elementwise lerp math, with all keypoints' samples batched into one [K, S]
gather so XLA emits a single fused gather kernel; on the GPU those reads
go through L1 and L2 as the reference's texture fetches did.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def bilinear_sample_pair(stack2: jnp.ndarray, lvl: jnp.ndarray,
                         ys: jnp.ndarray, xs: jnp.ndarray):
    """Bilinear-sample TWO channels (dx, dy) with ONE fused gather.

    A single `lax.gather` fetches a (2, 2, 2) slice per sample — both
    corner rows, both corner columns and both channels — so one gather
    replaces the 4 corners x 2 channels = 8 of the naive form.

    stack2: [L, H, W, 2]; lvl: [K] int32; ys, xs: [K, S] float32.
    Returns (v0 [K, S], v1 [K, S], in_bounds [K, S]).
    """
    _, h, w, _ = stack2.shape
    k, s = ys.shape
    inb = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    ys = jnp.clip(ys, 0.0, h - 1.000001)
    xs = jnp.clip(xs, 0.0, w - 1.000001)
    y0 = jnp.minimum(jnp.floor(ys).astype(jnp.int32), h - 2)
    x0 = jnp.minimum(jnp.floor(xs).astype(jnp.int32), w - 2)
    fy = (ys - y0)[..., None]
    fx = (xs - x0)[..., None]

    starts = jnp.stack([
        jnp.broadcast_to(lvl[:, None], (k, s)).reshape(-1),
        y0.reshape(-1), x0.reshape(-1)], axis=-1)              # [K*S, 3]
    dn = lax.GatherDimensionNumbers(offset_dims=(1, 2, 3),
                                    collapsed_slice_dims=(0,),
                                    start_index_map=(0, 1, 2))
    cube = lax.gather(stack2, starts, dn, slice_sizes=(1, 2, 2, 2),
                      mode=lax.GatherScatterMode.CLIP)
    cube = cube.reshape(k, s, 2, 2, 2)                         # [K,S,y,x,c]
    top = cube[:, :, 0, 0] * (1 - fx) + cube[:, :, 0, 1] * fx  # [K,S,2]
    bot = cube[:, :, 1, 0] * (1 - fx) + cube[:, :, 1, 1] * fx
    v = top * (1 - fy) + bot * fy
    return v[..., 0], v[..., 1], inb


def sample_grad_grid(gauss: jnp.ndarray, lvl: jnp.ndarray,
                     ys_rows: jnp.ndarray, xs_cols: jnp.ndarray):
    """Gradient sampling on an AXIS-ALIGNED per-slot grid.

    ys_rows [K, GR] and xs_cols [K, GC] define the grid; returns
    (dx, dy, inb) shaped [K, GR*GC] in row-major order.
    """
    k, gr = ys_rows.shape
    gc = xs_cols.shape[1]
    ys = jnp.broadcast_to(ys_rows[:, :, None], (k, gr, gc)).reshape(k, -1)
    xs = jnp.broadcast_to(xs_cols[:, None, :], (k, gr, gc)).reshape(k, -1)
    return sample_grad_pair(gauss, lvl, ys, xs)


def sample_grad_pair(gauss: jnp.ndarray, lvl: jnp.ndarray,
                     ys: jnp.ndarray, xs: jnp.ndarray):
    """Bilinear-sample image gradients of `gauss` at per-slot float coords.

    Central-difference gradient planes (zero on the border rows/columns)
    are materialised once per level stack and read with one fused
    4-corner gather per sample.

    gauss: [L, H, W] blurred levels; lvl: [K] int32; ys, xs: [K, S] f32.
    Returns (dx [K, S], dy [K, S], in_bounds [K, S]).
    """
    from .gaussian import image_gradients
    gdx, gdy = image_gradients(gauss)   # CSE'd across ori/desc inside a jit
    grad2 = jnp.stack([gdx, gdy], axis=-1)
    return bilinear_sample_pair(grad2, lvl, ys, xs)
