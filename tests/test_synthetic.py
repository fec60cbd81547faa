"""Synthetic data generators are self-consistent (they gate all SLAM tests)."""

import numpy as np
import pytest

from cusift_tpu.data.evaluation import ate_rmse, camera_centers, horn_align, rpe
from cusift_tpu.data.synthetic import planar_rgbd_sequence, warped_pair


def test_warped_pair_consistency():
    img_a, img_b, h = warped_pair(120, 160, seed=3)
    # centre pixel of b should equal the warped sample of a
    import cv2
    back = cv2.warpPerspective(img_b, h.astype(np.float64), (160, 120),
                               flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
    m = np.abs(back[20:-20, 20:-20] - img_a[20:-20, 20:-20])
    assert np.median(m) < 0.02


def test_rgbd_sequence_reprojection():
    """Depth + poses must reproject frame i pixels onto frame j correctly."""
    seq = planar_rgbd_sequence(n_frames=4, h=120, w=160, seed=1, motion_scale=0.5)
    fx, fy, cx, cy = seq.intr
    i, j = 0, 2
    # sample interior pixels of frame i
    us, vs = np.meshgrid(np.arange(40, 120, 7), np.arange(30, 90, 7))
    us, vs = us.ravel(), vs.ravel()
    z = seq.depths[i][vs, us]
    ok = z > 0
    pc = np.stack([(us - cx) / fx * z, (vs - cy) / fy * z, z], -1)[ok]
    # cam i -> world -> cam j
    ri, ti = seq.poses_r[i], seq.poses_t[i]
    rj, tj = seq.poses_r[j], seq.poses_t[j]
    pw = (pc - ti) @ ri            # R^T (p - t)
    pj = pw @ rj.T + tj
    uj = pj[:, 0] / pj[:, 2] * fx + cx
    vj = pj[:, 1] / pj[:, 2] * fy + cy
    inb = (uj > 2) & (uj < 157) & (vj > 2) & (vj < 117)
    # image values should agree (bilinear-ish: compare to nearest pixel)
    va = seq.images[i][vs, us][ok][inb]
    vb = seq.images[j][np.round(vj[inb]).astype(int), np.round(uj[inb]).astype(int)]
    assert np.median(np.abs(va - vb)) < 0.03
    # and reprojected depth should match frame j's depth map
    zb = seq.depths[j][np.round(vj[inb]).astype(int), np.round(uj[inb]).astype(int)]
    assert np.median(np.abs(zb - pj[inb][:, 2])) < 0.02


def test_ate_zero_for_identical():
    seq = planar_rgbd_sequence(n_frames=5, h=60, w=80, seed=0)
    assert ate_rmse(seq.poses_r, seq.poses_t, seq.poses_r, seq.poses_t) < 1e-6
    t_rpe, r_rpe = rpe(seq.poses_r, seq.poses_t, seq.poses_r, seq.poses_t)
    assert t_rpe < 1e-6 and r_rpe < 1e-5


def test_ate_alignment_invariance():
    """ATE must be invariant to a global rigid transform of the estimate."""
    seq = planar_rgbd_sequence(n_frames=6, h=60, w=80, seed=0)
    from cusift_tpu.optim.lie import se3_exp
    import jax.numpy as jnp
    dr, dt = (np.asarray(a) for a in se3_exp(jnp.asarray([0.3, -0.2, 0.1, 0.2, 0.1, -0.3])))
    # apply T_delta on the right: T_i' = T_i * T_delta (world re-anchoring)
    r2 = np.einsum("nij,jk->nik", seq.poses_r, dr)
    t2 = np.einsum("nij,j->ni", seq.poses_r, dt) + seq.poses_t
    assert ate_rmse(r2, t2, seq.poses_r, seq.poses_t) < 1e-5


def test_horn_align_recovers_transform(rng):
    pts = rng.normal(size=(30, 3))
    from scipy.spatial.transform import Rotation
    r = Rotation.from_rotvec([0.2, -0.4, 0.1]).as_matrix()
    t = np.array([1.0, -2.0, 0.5])
    s, r2, t2 = horn_align(pts, pts @ r.T + t)
    np.testing.assert_allclose(r2, r, atol=1e-8)
    np.testing.assert_allclose(t2, t, atol=1e-8)


@pytest.mark.parametrize("sigma", [1.2, 3.0, 6.0])
def test_gaussian_blur_matches_cv2(rng, sigma):
    """The scipy blur reproduces cv2.GaussianBlur (automatic kernel size,
    BORDER_REFLECT_101) on interior pixels."""
    cv2 = pytest.importorskip("cv2")
    from cusift_tpu.data.synthetic import gaussian_blur

    x = rng.normal(size=(96, 128)).astype(np.float32)
    ref = cv2.GaussianBlur(x, (0, 0), sigma,
                           borderType=cv2.BORDER_REFLECT_101)
    got = gaussian_blur(x, sigma)
    r = int(4 * sigma) + 1
    np.testing.assert_allclose(got[r:-r, r:-r], ref[r:-r, r:-r], atol=1e-5)


def test_warp_perspective_matches_cv2():
    """The scipy warp reproduces cv2.warpPerspective (INTER_LINEAR,
    BORDER_REFLECT_101) on interior pixels: cv2 quantises its bilinear
    weights to 1/32 px, the scipy form does not, hence the tolerance."""
    cv2 = pytest.importorskip("cv2")
    from cusift_tpu.data.synthetic import textured_image, warp_perspective

    img = textured_image(120, 160, seed=5, blobs=120, detail=0.25)
    _, _, h = warped_pair(120, 160, seed=7)
    ref = cv2.warpPerspective(img, h, (160, 120), flags=cv2.INTER_LINEAR,
                              borderMode=cv2.BORDER_REFLECT_101)
    got = warp_perspective(img, h, 120, 160)
    np.testing.assert_allclose(got[8:-8, 8:-8], ref[8:-8, 8:-8], atol=2e-3)


def test_textured_image_detail_needs_no_cv2(monkeypatch):
    """The detail bands that set the benchmark's keypoint density render
    with numpy/scipy alone (cv2 import blocked)."""
    import sys
    from cusift_tpu.data.synthetic import textured_image

    base = textured_image(64, 80, seed=2, detail=0.0)
    monkeypatch.setitem(sys.modules, "cv2", None)
    a = textured_image(64, 80, seed=2, detail=0.25, detail_octaves=2)
    b = textured_image(64, 80, seed=2, detail=0.25, detail_octaves=2)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - base).mean() > 0.01
