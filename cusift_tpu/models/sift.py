"""End-to-end SIFT extraction pipeline (the flagship "model").

Reference analog: ``ExtractSift`` / ``ExtractSiftLoop`` / ``ExtractSiftOctave``
host orchestration (SURVEY.md C11, §3.1).  The reference reads the keypoint
counter back to the host between stages (a sync bubble per octave); here the
whole pipeline — pyramid, detection, orientation, descriptors, compaction —
is ONE jitted function with static shapes, so a single XLA program runs per
frame with zero host round-trips.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SiftConfig
from ..ops.describe import compact_slots, descriptors
from ..ops.detect import detect_from_score, extrema_score
from ..ops.gaussian import downsample2
from ..ops.orientation import dominant_orientations, orientation_histograms
from ..ops.pyramid import initial_level, octave_levels


class SiftFeatures(NamedTuple):
    """Static-capacity feature set: one row per (keypoint, orientation) slot.

    The reference's ``SiftData`` array of ``SiftPoint`` structs
    (SURVEY.md C4) as a struct-of-arrays with a validity mask.
    """

    x: jnp.ndarray            # [N] base-image column
    y: jnp.ndarray            # [N] base-image row
    sigma: jnp.ndarray        # [N]
    orientation: jnp.ndarray  # [N] radians
    response: jnp.ndarray     # [N] DoG contrast ("sharpness")
    edgeness: jnp.ndarray     # [N]
    octave: jnp.ndarray       # [N] int32
    desc: jnp.ndarray         # [N, 128] L2-normalised
    valid: jnp.ndarray        # [N] bool

    @property
    def count(self):
        return jnp.sum(self.valid.astype(jnp.int32))


def _features_from(slots, desc: jnp.ndarray, slot_valid: jnp.ndarray) -> SiftFeatures:
    return SiftFeatures(
        x=slots.x, y=slots.y, sigma=slots.sigma, orientation=slots.theta,
        response=slots.response, edgeness=slots.edgeness,
        octave=slots.octave, desc=desc, valid=slot_valid,
    )


def _concat(parts: list[SiftFeatures]) -> SiftFeatures:
    return jax.tree.map(lambda *xs: jnp.concatenate(xs, 0), *parts)


def _topk(feats: SiftFeatures, n: int) -> SiftFeatures:
    if feats.valid.shape[0] < n:  # pad up to the static output capacity
        pad = n - feats.valid.shape[0]
        feats = jax.tree.map(
            lambda a: jnp.concatenate(
                [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)], 0), feats)
    score = jnp.where(feats.valid, jnp.abs(feats.response), -jnp.inf)
    _, idx = jax.lax.top_k(score, n)
    out = jax.tree.map(lambda a: a[idx], feats)
    valid = out.valid & jnp.isfinite(score[idx])
    # zero every field of dead lanes: invalid-slot content is tie-order
    # dependent (top_k) and must never leak downstream
    out = jax.tree.map(
        lambda a: jnp.where(valid.reshape(valid.shape + (1,) * (a.ndim - 1)),
                            a, jnp.zeros_like(a)), out)
    return out._replace(valid=valid)


def _octave_planes(img: jnp.ndarray, cfg: SiftConfig):
    """Per octave: (sample_levels [S,H,W], dog [S+2,H,W], score [S,H,W]).

    The blur chain builds the levels, the DoG is their difference, and the
    dense extremum test scores every pixel.
    """
    s_ = cfg.scales_per_octave
    n_oct = cfg.num_octaves_for(*img.shape)
    base = initial_level(img, cfg)
    out = []
    for _ in range(n_oct):
        levels = octave_levels(base, cfg)
        gauss = jnp.stack(levels)
        dog = gauss[1:] - gauss[:-1]
        samp = gauss[1:s_ + 1]
        # scores only rank candidates into the static budget; bf16 halves
        # the bytes of the dense window max/min stage (config.py
        # score_dtype).  Refinement gathers read the f32 DoG either way.
        sdog = (dog.astype(jnp.bfloat16) if cfg.score_dtype == "bf16"
                else dog)
        score = extrema_score(sdog, cfg)   # bf16 rides through top-k
        out.append((samp, dog, score))
        base = downsample2(samp[s_ - 1])   # level S carries 2x sigma0 blur
    return out


@partial(jax.jit, static_argnames=("cfg",))
def extract(img: jnp.ndarray, cfg: SiftConfig = SiftConfig()) -> SiftFeatures:
    """SIFT features of a [H, W] grayscale image in [0, 1].

    Returns a SiftFeatures buffer of static capacity cfg.total_kpts.
    """
    parts = []
    for oi, (samp, dog, score) in enumerate(_octave_planes(img, cfg)):
        kps = detect_from_score(dog, score, oi, cfg)
        # keypoints only live on DoG levels 1..S, which is exactly the
        # sampler-level stack (the sampler computes gradients itself)
        hist = orientation_histograms(samp, kps, cfg, level_base=1)
        theta, ok = dominant_orientations(hist, cfg)
        slots = compact_slots(kps, theta, ok, cfg.desc_slots(oi))
        desc, slot_valid = descriptors(samp, slots, cfg, level_base=1)
        parts.append(_features_from(slots, desc, slot_valid))
    return _topk(_concat(parts), cfg.total_kpts)


@partial(jax.jit, static_argnames=("cfg",))
def extract_batch(imgs: jnp.ndarray, cfg: SiftConfig = SiftConfig()) -> SiftFeatures:
    """vmapped extraction over a [B, H, W] batch of frames."""
    return jax.vmap(lambda im: extract(im, cfg))(imgs)
