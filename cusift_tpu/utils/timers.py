"""Wall-clock timing around jitted calls.

Reference analog: ``TimerGPU`` (cudaEvent pairs) / ``TimerCPU`` in
``cudautils.h`` (SURVEY.md §5.1).  In JAX, dispatch is async; correct timing
requires `jax.block_until_ready` on the result.  For kernel-level traces use
`jax.profiler.trace` (exposed via the bench harness `--profile` flag).
"""

from __future__ import annotations

import contextlib
import time

import jax


class Timer:
    """Accumulating wall-clock timer; `with t: ...` adds one sample."""

    def __init__(self, name: str = ""):
        self.name = name
        self.samples: list[float] = []

    @contextlib.contextmanager
    def __call__(self, result=None):
        t0 = time.perf_counter()
        yield
        if result is not None:
            jax.block_until_ready(result)
        self.samples.append(time.perf_counter() - t0)

    def time(self, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        jax.block_until_ready(out)
        self.samples.append(time.perf_counter() - t0)
        return out

    @property
    def best(self) -> float:
        return min(self.samples) if self.samples else float("nan")

    @property
    def mean(self) -> float:
        return sum(self.samples) / len(self.samples) if self.samples else float("nan")
