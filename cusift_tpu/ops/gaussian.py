"""Separable Gaussian filtering.

Reference analog: cuSIFT's ``LowPass`` / ``LaplaceMulti`` CUDA kernels
(SURVEY.md C5–C7) keep filter taps in ``__constant__`` memory and tile the
image with shared-memory halos.  Here the filter is a separable sum of
shifted slices with the taps baked into the HLO as compile-time constants,
which XLA fuses into one elementwise loop per pass.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


# banded-matmul convs ("mxu", "mxu2") run in full f32: see _conv1d_mxu
CONV_PRECISION = lax.Precision.HIGHEST


def gaussian_taps(sigma: float, radius: int | None = None) -> np.ndarray:
    """1-D Gaussian filter taps (numpy, compile-time constant).

    Radius defaults to ceil(4*sigma) like cv2.getGaussianKernel's automatic
    size for float images ("small" sigmas keep at least radius 1).
    """
    if radius is None:
        radius = max(1, int(math.ceil(4.0 * float(sigma))))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    w = np.exp(-(x * x) / (2.0 * float(sigma) ** 2))
    w /= w.sum()
    return w.astype(np.float32)


def _reflect_pad(img: jnp.ndarray, r: int, axis: int) -> jnp.ndarray:
    """BORDER_REFLECT_101 padding (matches cv2.GaussianBlur's default)."""
    if r == 0:
        return img
    pad = [(0, 0)] * img.ndim
    pad[axis] = (r, r)
    return jnp.pad(img, pad, mode="reflect")


def _conv1d(img: jnp.ndarray, taps: np.ndarray, axis: int) -> jnp.ndarray:
    """Correlate a [..., H, W] image with static taps along `axis`.

    Implemented as a statically-unrolled sum of shifted slices rather than
    `lax.conv`: a 1-channel convolution leaves a convolution library with
    no channel dimension to vectorise over, while shifted slices of a
    padded array are contiguous views that XLA fuses into a single
    elementwise loop.  Exact f32 arithmetic.
    """
    r = (taps.shape[0] - 1) // 2
    x = _reflect_pad(img, r, axis)
    n = img.shape[axis]
    ax = axis % img.ndim
    out = None
    for k, w in enumerate(taps.tolist()):
        sl = [slice(None)] * img.ndim
        sl[ax] = slice(k, k + n)
        term = jnp.float32(w) * x[tuple(sl)]
        out = term if out is None else out + term
    return out


def _band_matrix(taps: np.ndarray, block: int = 128) -> np.ndarray:
    """[block + 2r, block] banded correlation operator (static constant).

    out[c] = sum_j taps[j] * window[c + j]  ->  T[k, c] = taps[k - c].
    """
    r = (taps.shape[0] - 1) // 2
    t = np.zeros((block + 2 * r, block), np.float32)
    for c in range(block):
        t[c:c + 2 * r + 1, c] = taps
    return t


def _conv1d_mxu(img: jnp.ndarray, taps: np.ndarray, axis: int,
                block: int = 128) -> jnp.ndarray:
    """Separable conv as blocked banded matmuls.

    A 128-wide output block contracts its [block + 2r] input window
    against a static banded [block+2r, block] operator.  The FLOP count
    rises ~(2r+1)/3-fold over the shifted-add form in exchange for
    running on a matrix unit.  Precision is pinned to HIGHEST (full f32):
    the downstream DoG differences cancel most of the blurred value, so a
    TF32 or single bf16 pass (~1e-3 relative) would swamp them.
    """
    r = (taps.shape[0] - 1) // 2
    ax = axis % img.ndim
    n = img.shape[ax]
    nb = -(-n // block)
    x = _reflect_pad(img, r, ax)
    if nb * block != n:  # zero-tail so every window is full
        pad = [(0, 0)] * img.ndim
        pad[ax] = (0, nb * block - n)
        x = jnp.pad(x, pad)
    t = jnp.asarray(_band_matrix(taps, block))                 # [B+2r, B]

    win = block + 2 * r
    sl_all = [slice(None)] * img.ndim
    windows = []
    for b in range(nb):
        sl = list(sl_all)
        sl[ax] = slice(b * block, b * block + win)
        windows.append(x[tuple(sl)])
    w = jnp.stack(windows)                                     # [nb, ..., win(ax)]

    if ax == img.ndim - 1:
        out = jnp.einsum("...k,kc->...c", w, t,
                         precision=CONV_PRECISION,
                         preferred_element_type=jnp.float32)
        out = jnp.moveaxis(out, 0, -2)                         # [..., nb, B]
        out = out.reshape(out.shape[:-2] + (nb * block,))
    else:
        assert ax == img.ndim - 2
        out = jnp.einsum("...kw,kc->...cw", w, t,
                         precision=CONV_PRECISION,
                         preferred_element_type=jnp.float32)
        out = jnp.moveaxis(out, 0, -3)                         # [..., nb, B, W]
        out = out.reshape(out.shape[:-3] + (nb * block,) + out.shape[-1:])
    sl = list(sl_all)
    sl[ax] = slice(0, n)
    return out[tuple(sl)]


def _conv1d_windows(x: jnp.ndarray, tmats: jnp.ndarray, r: int, axis: int,
                    block: int, batched_in: bool = False) -> jnp.ndarray:
    """Output-layout window-stacked banded conv along `axis` (last or -2).

    The shared core of `_conv1d_mxu2` and the direct-pyramid pass
    (ops/pyramid.py): reflect-pad by `r`, zero-pad the axis to a block
    multiple (AFTER the reflect pad — the trailing garbage lands past the
    last valid output and is trimmed), stack the overlapping windows at
    the OUTPUT position (no post-einsum transpose for XLA to materialise),
    contract against the banded operator(s), reshape into place, trim.

    tmats: [win, B] for one operator, or [L, win, B] for one operator per
    level — the output then carries a leading L axis; `batched_in` says
    `x` already carries it (each level contracts against its own
    operator).  Numerics identical to the leading-axis `_conv1d_mxu`
    form (same banded operator, same precision).
    """
    multi = tmats.ndim == 3
    ax = axis % x.ndim
    n = x.shape[ax]
    nb = -(-n // block)
    xp = _reflect_pad(x, r, ax)
    if nb * block != n:
        pad = [(0, 0)] * x.ndim
        pad[ax] = (0, nb * block - n)
        xp = jnp.pad(xp, pad)
    win = block + 2 * r
    sl_all = [slice(None)] * x.ndim
    windows = []
    for b in range(nb):
        sl = list(sl_all)
        sl[ax] = slice(b * block, b * block + win)
        windows.append(xp[tuple(sl)])
    last = ax == x.ndim - 1
    assert last or ax == x.ndim - 2
    wst = jnp.stack(windows, axis=ax)       # [..., nb, win(, W)]
    lhs = ("l" if batched_in else "") + ("...nk" if last else "...nkw")
    rhs = "lkc" if multi else "kc"
    out_axes = ("l" if multi else "") + ("...nc" if last else "...ncw")
    out = jnp.einsum(f"{lhs},{rhs}->{out_axes}", wst, tmats,
                     precision=CONV_PRECISION,
                     preferred_element_type=jnp.float32)
    if last:
        out = out.reshape(out.shape[:-2] + (nb * block,))
    else:
        out = out.reshape(out.shape[:-3] + (nb * block,) + out.shape[-1:])
    sl = [slice(None)] * out.ndim
    sl[ax + (1 if multi and not batched_in else 0)] = slice(0, n)
    return out[tuple(sl)]


def _conv1d_mxu2(img: jnp.ndarray, taps: np.ndarray, axis: int,
                 block: int = 128) -> jnp.ndarray:
    """`_conv1d_mxu` with output-layout window stacking.

    The v1 form stacks windows on a LEADING axis and `moveaxis`es the
    einsum result back — a relayout XLA must materialise.  Here windows
    stack directly at the output position so the einsum result reshapes
    into place with no transpose.  Numerics identical (same banded
    operator, same precision).
    """
    r = (taps.shape[0] - 1) // 2
    t = jnp.asarray(_band_matrix(taps, block))                 # [win, B]
    return _conv1d_windows(img, t, r, axis, block)


_CONVS = {"vpu": _conv1d, "mxu": _conv1d_mxu, "mxu2": _conv1d_mxu2}


def blur(img: jnp.ndarray, sigma: float, radius: int | None = None,
         backend: str = "vpu") -> jnp.ndarray:
    """Separable Gaussian blur of a [..., H, W] image; sigma is static.

    backend: "vpu" (shifted adds), "mxu" (banded matmuls), or "mxu2"
    (banded matmuls with window stacking in output layout).
    """
    if float(sigma) <= 0.0:
        return img
    taps = gaussian_taps(sigma, radius)
    conv = _CONVS[backend]
    return conv(conv(img, taps, axis=-2), taps, axis=-1)


def downsample2(img: jnp.ndarray) -> jnp.ndarray:
    """Reference ``ScaleDown``: stride-2 decimation. The source level already
    carries 2x the base blur, so no extra low-pass is required (Lowe '04)."""
    return img[..., ::2, ::2]


def upsample2(img: jnp.ndarray) -> jnp.ndarray:
    """Reference ``ScaleUp``: 2x bilinear upsample (for the optional octave -1)."""
    h, w = img.shape[-2], img.shape[-1]
    return jax.image.resize(img, img.shape[:-2] + (2 * h, 2 * w), method="bilinear")


@partial(jax.jit, static_argnums=())
def image_gradients(img: jnp.ndarray):
    """Central-difference gradients (dx, dy) with replicated borders.

    Used by orientation/descriptor stages; matches the 2-tap [-1,0,1]/2
    scheme of classic SIFT implementations.
    """
    dx = 0.5 * (jnp.roll(img, -1, axis=-1) - jnp.roll(img, 1, axis=-1))
    dy = 0.5 * (jnp.roll(img, -1, axis=-2) - jnp.roll(img, 1, axis=-2))
    # zero out the wrapped border columns/rows
    w = img.shape[-1]
    h = img.shape[-2]
    col = jnp.arange(w)
    row = jnp.arange(h)
    dx = dx * ((col > 0) & (col < w - 1))
    dy = dy * ((row > 0) & (row < h - 1))[:, None]
    return dx, dy
