"""Matmul-precision pinning for accuracy-critical small-matrix math.

On the GPU, an f32 `jnp.dot`/`@` at default precision may run in TF32
(~3 decimal digits).  That is the right trade for the big
descriptor-matching matmuls, but it is catastrophic for 3x3 rotation
algebra, 8x8 DLT normal equations, and Schur-complement blocks — a single
reduced-precision `K @ K` in Rodrigues already costs ~1e-3 absolute error
in the rotation matrix.  The geometry/optimisation
modules therefore pin their matmuls to float32 accumulation with this
decorator; it is a trace-time setting, so it composes with jit/vmap/scan
and costs nothing on the CPU backend.
"""

from __future__ import annotations

import functools

import jax


def f32_matmuls(fn):
    """Trace `fn` under float32 default matmul precision."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    return wrapped
