"""Host-side image plumbing.

Reference analog: the ``CudaImage`` container (SURVEY.md C3) and the OpenCV
image loading in the demo (C16).  In JAX there is no pitched-pointer
management — `jax.device_put` of a statically-shaped array is the whole
"Download"; this module only normalises formats and pads to canonical shapes
so the jitted pipelines compile once per shape tier (SURVEY.md §7 hard part
#5).
"""

from __future__ import annotations

import numpy as np

# Canonical (H, W) tiers; every input is padded up to the smallest fitting
# tier so jit caches stay small.
SHAPE_TIERS = ((480, 640), (376, 1248), (960, 1280), (1536, 2048))


def import_cv2(purpose: str):
    """OpenCV, imported where user files are read or drawn (never on the
    main path); a clear error if it is not installed."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{purpose} needs OpenCV (cv2), which is not "
                          "installed") from e
    return cv2


def to_gray_float(img: np.ndarray) -> np.ndarray:
    """uint8/float, gray/RGB -> float32 grayscale in [0, 1]."""
    img = np.asarray(img)
    # scale by the INPUT dtype, captured before the luminance conversion
    # promotes to float: a dark uint8 frame whose max is 1 must still map
    # 1 -> 1/255, and a colour uint8 image must not skip the /255
    dtype = img.dtype
    if img.ndim == 3:
        # luminance weights (Rec. 601), matching cv2.cvtColor BGR2GRAY
        b, g, r = img[..., 0], img[..., 1], img[..., 2]
        img = 0.114 * b + 0.587 * g + 0.299 * r
    img = img.astype(np.float32)
    if np.issubdtype(dtype, np.integer):
        img = img / float(np.iinfo(dtype).max)
    return img


def pad_to_tier(img: np.ndarray):
    """Zero-pad [H, W] up to the smallest canonical tier; returns (img, (h, w))."""
    h, w = img.shape
    for th, tw in SHAPE_TIERS:
        if h <= th and w <= tw:
            out = np.zeros((th, tw), np.float32)
            out[:h, :w] = img
            return out, (h, w)
    return img, (h, w)
