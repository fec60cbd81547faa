"""Host->device frame pipelining.

The reference streams frames over PCIe with `cudaMemcpy` per frame
(SURVEY.md C3 ``Download``); here the analogous `device_put` pays a fixed
latency per transfer, which 2 uploads + 1 result fetch per frame would add
to every frame of a 30 Hz stream.  This module hides upload latency behind
compute:

* frames (image + depth) are packed into ONE [2, H, W] array so each frame
  costs one transfer instead of two;
* a daemon thread uploads frame i+1 while the device processes frame i
  (bounded queue, depth 2 — classic double buffering, the device-side analog
  of the native loader's decode prefetch in native/frameloader.cpp).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import jax
import numpy as np


def pack_frame(img: np.ndarray, depth: np.ndarray | None) -> np.ndarray:
    """Stack image + depth into one [2, H, W] host array (one upload)."""
    if depth is None:
        depth = np.zeros_like(img)
    return np.stack([np.asarray(img, np.float32),
                     np.asarray(depth, np.float32)])


def _prefetched(produce, prefetch: int) -> Iterator:
    """Drain `produce(emit)` through a bounded queue fed by a daemon thread.

    `produce` is called with an `emit(item)` callback; emitted items are
    yielded in order while at most `prefetch` of them are in flight, so
    upload latency overlaps the consumer's compute.

    Producer exceptions (corrupt frame, IO error mid-sequence) are re-raised
    in the consumer instead of being swallowed as a clean end-of-stream; if
    the consumer stops early (max_frames break), a cancel flag unblocks the
    producer so it does not pin prefetched device buffers forever.
    """
    q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
    stop = object()
    cancelled = threading.Event()

    class _Cancelled(Exception):
        pass

    def emit(item):
        # Bounded put that gives up when the consumer has gone away.
        while not cancelled.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue
        raise _Cancelled

    def worker():
        outcome = None
        try:
            produce(emit)
        except _Cancelled:
            return  # consumer exited early; nothing to deliver
        except BaseException as exc:  # noqa: BLE001 — forwarded, not dropped
            outcome = exc
        try:
            emit((stop, outcome))
        except _Cancelled:
            pass

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is stop:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        cancelled.set()


def device_frames(frames: Iterable, prefetch: int = 2) -> Iterator:
    """Yield device-resident packed frames, uploading ahead of consumption.

    ``frames``: iterable of (img, depth) numpy pairs (depth may be None).
    """

    def produce(emit):
        for img, depth in frames:
            emit(jax.device_put(pack_frame(img, depth)))

    return _prefetched(produce, prefetch)


def device_chunks(frames: Iterable, chunk: int, prefetch: int = 2) -> Iterator:
    """Yield device-resident [n, 2, H, W] chunks (n <= chunk), prefetched.

    The final chunk is padded by repeating its last frame so every dispatch
    sees the same static shape; the true frame count is returned alongside.
    Yields (chunk_array, n_valid).
    """

    def produce(emit):
        buf = []
        for img, depth in frames:
            buf.append(pack_frame(img, depth))
            if len(buf) == chunk:
                emit((jax.device_put(np.stack(buf)), chunk))
                buf = []
        if buf:
            n = len(buf)
            buf = buf + [buf[-1]] * (chunk - n)
            emit((jax.device_put(np.stack(buf)), n))

    return _prefetched(produce, prefetch)
