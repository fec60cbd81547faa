"""utils/image.py: grayscale conversion + shape tiering."""

import numpy as np

from cusift_tpu.utils.image import SHAPE_TIERS, pad_to_tier, to_gray_float


def test_gray_uint8_scaling(rng):
    img = (rng.random((8, 10)) * 255).astype(np.uint8)
    out = to_gray_float(img)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, img / 255.0, atol=1e-6)


def test_gray_dark_uint8_still_scaled():
    img = np.ones((4, 4), np.uint8)     # max intensity 1: dtype decides
    np.testing.assert_allclose(to_gray_float(img), 1 / 255.0, atol=1e-7)


def test_color_uint8_normalised(rng):
    bgr = (rng.random((6, 7, 3)) * 255).astype(np.uint8)
    out = to_gray_float(bgr)
    assert out.max() <= 1.0 + 1e-6
    want = (0.114 * bgr[..., 0] + 0.587 * bgr[..., 1]
            + 0.299 * bgr[..., 2]) / 255.0
    np.testing.assert_allclose(out, want.astype(np.float32), atol=1e-6)


def test_float_passthrough(rng):
    img = rng.random((5, 5)).astype(np.float32)
    np.testing.assert_array_equal(to_gray_float(img), img)


def test_pad_to_tier(rng):
    img = rng.random((100, 200)).astype(np.float32)
    out, (h, w) = pad_to_tier(img)
    assert (h, w) == (100, 200)
    assert out.shape == SHAPE_TIERS[0]
    np.testing.assert_array_equal(out[:100, :200], img)
    assert out[100:].sum() == 0.0
    big = rng.random((2000, 3000)).astype(np.float32)
    out2, _ = pad_to_tier(big)
    assert out2.shape == (2000, 3000)   # beyond all tiers: unchanged


def test_import_cv2_names_the_purpose(monkeypatch):
    """Off the main path OpenCV is optional: a missing cv2 fails with a
    message saying what needed it."""
    import sys
    import pytest
    from cusift_tpu.utils.image import import_cv2

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="drawing keypoints needs OpenCV"):
        import_cv2("drawing keypoints")
