"""P1 exit test (SURVEY.md §7): pyramid levels match cv2.GaussianBlur."""

import cv2
import numpy as np
import jax
import pytest

from cusift_tpu.config import SiftConfig
from cusift_tpu.ops.gaussian import blur, downsample2, upsample2
from cusift_tpu.ops.pyramid import build_pyramid


def test_blur_matches_cv2(test_image):
    for sigma in (0.8, 1.6, 3.2):
        ours = np.asarray(blur(test_image, sigma))
        ref = cv2.GaussianBlur(test_image, (0, 0), sigma,
                               borderType=cv2.BORDER_REFLECT_101)
        assert np.max(np.abs(ours - ref)) < 2e-3, f"sigma={sigma}"


def test_pyramid_shapes_and_blur(test_image):
    cfg = SiftConfig()
    octaves = jax.jit(lambda im: build_pyramid(im, cfg))(test_image)
    assert len(octaves) == cfg.num_octaves_for(*test_image.shape)
    h, w = test_image.shape
    for o, oct_ in enumerate(octaves):
        assert oct_.gauss.shape == (cfg.levels_per_octave, h >> o, w >> o)
        assert oct_.dog.shape == (cfg.levels_per_octave - 1, h >> o, w >> o)

    # level s of octave 0 == direct blur of level 0 with the absolute sigma
    sig = cfg.sigmas()
    for s in (1, 3, 5):
        target = np.sqrt(sig[s] ** 2 - sig[0] ** 2)
        ref = np.asarray(blur(octaves[0].gauss[0], float(target)))
        got = np.asarray(octaves[0].gauss[s])
        assert np.max(np.abs(got - ref)) < 2e-3, f"level {s}"


def test_dog_is_difference(test_image):
    cfg = SiftConfig(num_octaves=2)
    octaves = jax.jit(lambda im: build_pyramid(im, cfg))(test_image)
    g, d = np.asarray(octaves[0].gauss), np.asarray(octaves[0].dog)
    np.testing.assert_allclose(d, g[1:] - g[:-1], atol=1e-6)


def test_up_down_sample(test_image):
    up = np.asarray(upsample2(test_image))
    assert up.shape == (2 * test_image.shape[0], 2 * test_image.shape[1])
    down = np.asarray(downsample2(test_image))
    np.testing.assert_allclose(down, test_image[::2, ::2])


def test_blur_mxu_matches_vpu(rng):
    """The banded-matmul conv == the shifted-add form.

    Both run in exact f32 (the banded matmuls at Precision.HIGHEST), so
    the comparison checks the banded-operator construction and block
    stitching bit-tight."""
    from cusift_tpu.ops.gaussian import blur

    for shape in ((96, 160), (2, 120, 130), (41, 257)):
        x = np.asarray(rng.random(shape), np.float32)
        for sigma in (1.1, 3.6):
            a = np.asarray(blur(x, sigma, backend="vpu"))
            b = np.asarray(blur(x, sigma, backend="mxu"))
            np.testing.assert_allclose(a, b, atol=1e-6)


def test_blur_mxu2_matches_vpu(rng):
    """Output-layout window stacking (mxu2) == the shifted-add form."""
    for shape in ((96, 160), (2, 120, 130), (41, 257)):
        x = np.asarray(rng.random(shape), np.float32)
        for sigma in (1.1, 3.6):
            a = np.asarray(blur(x, sigma, backend="vpu"))
            b = np.asarray(blur(x, sigma, backend="mxu2"))
            np.testing.assert_allclose(a, b, atol=1e-6)


def test_octave_levels_direct_matches_chain(rng):
    """Direct-from-base levels == incremental chain (Gaussians compose).

    The direct build uses cumulative-sigma taps at a shared max radius;
    the chain accumulates blur by repeated convolution.  They agree to
    the tap-truncation tolerance of the cv2 radius rule (radius
    4*sigma), which is the same tolerance the cv2 parity test accepts.
    """
    from cusift_tpu.config import replace
    from cusift_tpu.ops.pyramid import octave_levels, octave_levels_direct

    cfg = SiftConfig(num_octaves=1)
    base = np.asarray(rng.random((120, 160)), np.float32)
    chain = octave_levels(base, cfg)
    direct = octave_levels_direct(base, cfg)
    assert len(chain) == len(direct)
    for a, b in zip(chain, direct):
        assert np.max(np.abs(np.asarray(a) - np.asarray(b))) < 2e-3

    # and the full extractor agrees end-to-end on keypoint geometry
    from cusift_tpu.models.sift import extract
    img = np.asarray(rng.random((120, 160)), np.float32)
    small = SiftConfig(max_kpts=256, max_kpts_per_octave=128, num_octaves=3)
    fa = extract(img, small)
    fb = extract(img, replace(small, pyramid_impl="direct"))
    na, nb = int(fa.count), int(fb.count)
    assert abs(na - nb) <= max(2, 0.05 * na)
