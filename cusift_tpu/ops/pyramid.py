"""Gaussian scale-space pyramid + difference-of-Gaussians.

Reference analog: cuSIFT's per-octave ``LaplaceMulti`` fused kernel computing
~6 blur levels and 5 DoG planes per octave (SURVEY.md C7, hot loop #1) and
the ``ScaleDown`` octave seeding (C6).  Design: one jitted function per
image shape; octaves are a static Python loop (unrolled at trace time), the
levels of an octave are stacked into a single ``[S+3, H, W]`` array so every
downstream op is batched.  No host syncs anywhere (the reference's per-octave
point-count readbacks disappear; SURVEY.md §3.1).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..config import SiftConfig
from .gaussian import blur, downsample2, upsample2


class Octave(NamedTuple):
    gauss: jnp.ndarray  # [S+3, H, W] blurred levels
    dog: jnp.ndarray    # [S+2, H, W] difference of gaussians


def initial_level(img: jnp.ndarray, cfg: SiftConfig) -> jnp.ndarray:
    """Octave-0 base: optional 2x upsample + blur up to sigma0.

    (Reference: ScaleUp + LowPass + initBlur handling, SURVEY.md C5-C6.)
    """
    assert img.ndim == 2, "one image; batch via vmap/shard_map at the call site"
    img = img.astype(jnp.float32)
    if cfg.upscale:
        base = upsample2(img)
        assumed = cfg.init_blur * 2.0
    else:
        base = img
        assumed = cfg.init_blur
    delta = max(cfg.sigma0 ** 2 - assumed ** 2, 0.01) ** 0.5
    return blur(base, delta, backend=cfg.conv_backend)


def octave_levels(base: jnp.ndarray, cfg: SiftConfig) -> list[jnp.ndarray]:
    """All S+3 blur levels of one octave from its sigma0 base.

    `cfg.pyramid_impl` selects the build: "chain" (incremental blurs,
    the reference LaplaceMulti structure, SURVEY.md C7) or "direct"
    (every level straight from the base with cumulative-sigma taps —
    2 batched einsums per octave instead of 2(S+2), trading ~2x FLOPs
    for far fewer kernel launches/relayouts; Gaussians compose exactly,
    so numerics agree to f32 roundoff).
    """
    if cfg.pyramid_impl == "direct":
        return octave_levels_direct(base, cfg)
    levels = [base]
    for s in cfg.incremental_sigmas():
        levels.append(blur(levels[-1], s, backend=cfg.conv_backend))
    return levels


def octave_levels_direct(base: jnp.ndarray, cfg: SiftConfig,
                         block: int = 128) -> list[jnp.ndarray]:
    """All S+2 non-base levels straight from the base in ONE batched pass.

    The level axis rides the einsum batch dimension: one rows-pass and
    one cols-pass per octave, each contracting against a [L, win, B]
    stack of banded operators (cumulative sigmas, shared max radius).
    """
    import math

    from .gaussian import _band_matrix, _conv1d_windows, gaussian_taps

    sigmas = []
    acc = 0.0
    for s in cfg.incremental_sigmas():
        acc = math.sqrt(acc * acc + s * s)
        sigmas.append(acc)
    rmax = max(1, int(math.ceil(4.0 * sigmas[-1])))
    tmats = jnp.asarray(
        np.stack([_band_matrix(gaussian_taps(s, rmax), block)
                  for s in sigmas]))                       # [L, win, B]

    rows = _conv1d_windows(base, tmats, rmax, -2, block)   # [L, H, W]
    blurred = _conv1d_windows(rows, tmats, rmax, -1, block,
                              batched_in=True)
    return [base] + [blurred[i] for i in range(len(sigmas))]


def build_pyramid(img: jnp.ndarray, cfg: SiftConfig) -> list[Octave]:
    """Build the full scale space for a [H, W] float image in [0, 1].

    Returns one Octave per octave, finest first.  Octave o has spatial size
    (H >> o, W >> o) relative to the base image (2x input if cfg.upscale).
    """
    n_oct = cfg.num_octaves_for(*img.shape)
    octaves = []
    current = initial_level(img, cfg)
    for _ in range(n_oct):
        levels = octave_levels(current, cfg)
        gauss = jnp.stack(levels)               # [S+3, H, W]
        dog = gauss[1:] - gauss[:-1]            # [S+2, H, W]
        octaves.append(Octave(gauss=gauss, dog=dog))
        # Seed next octave from the level carrying 2*sigma0 blur (index S).
        current = downsample2(levels[cfg.scales_per_octave])
    return octaves
