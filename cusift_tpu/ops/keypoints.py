"""Static-capacity keypoint buffers (struct-of-arrays).

Reference analog: the ``SiftPoint``/``SiftData`` POD structs and the
atomic-append ``d_PointCounter`` device counter (SURVEY.md C4, C8).  XLA
has no atomics-into-global-buffer idiom and wants static shapes, so the
variable-length keypoint list becomes a fixed-capacity struct-of-arrays with
a validity mask; "append" becomes top-k compaction by detection response
(SURVEY.md §7 design decision #1).  Invalid lanes carry zeros and must be
masked by every consumer.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Keypoints(NamedTuple):
    """[K]-shaped struct-of-arrays; `valid` masks live lanes.

    Coordinates exist in two frames:
      * (x, y, sigma): base input-image frame (what users / matchers see),
      * (xo, yo, so, octave, level): octave-local frame used by the
        orientation / descriptor samplers (so = level + subscale offset).
    `response` is the refined DoG contrast (reference `sharpness`),
    `edgeness` the Hessian trace^2/det ratio.
    """

    x: jnp.ndarray          # [K] float32
    y: jnp.ndarray          # [K] float32
    sigma: jnp.ndarray      # [K] float32, blur in base-image units
    response: jnp.ndarray   # [K] float32
    edgeness: jnp.ndarray   # [K] float32
    octave: jnp.ndarray     # [K] int32
    level: jnp.ndarray      # [K] int32 (DoG level the extremum lives on, 1..S)
    xo: jnp.ndarray         # [K] float32, octave-local column
    yo: jnp.ndarray         # [K] float32, octave-local row
    so: jnp.ndarray         # [K] float32, refined level coordinate
    valid: jnp.ndarray      # [K] bool

    @property
    def count(self):
        return jnp.sum(self.valid.astype(jnp.int32))


def empty_keypoints(k: int) -> Keypoints:
    f = jnp.zeros((k,), jnp.float32)
    i = jnp.zeros((k,), jnp.int32)
    return Keypoints(x=f, y=f, sigma=f, response=f, edgeness=f,
                     octave=i, level=i, xo=f, yo=f, so=f,
                     valid=jnp.zeros((k,), bool))


def concat_keypoints(parts: list[Keypoints]) -> Keypoints:
    return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *parts)


def topk_keypoints(kps: Keypoints, k: int) -> Keypoints:
    """Compact to the k highest-|response| valid keypoints (static shape)."""
    score = jnp.where(kps.valid, jnp.abs(kps.response), -jnp.inf)
    _, idx = jax.lax.top_k(score, k)
    out = jax.tree.map(lambda a: a[idx], kps)
    return out._replace(valid=out.valid & jnp.isfinite(score[idx]))


def take(kps: Keypoints, idx: jnp.ndarray) -> Keypoints:
    return jax.tree.map(lambda a: a[idx], kps)
