"""Order-invariant comparison fixtures against the OpenCV SIFT oracle.

SURVEY.md §4.2: accelerator keypoint order is meaningless; compare sets by
greedy bipartite matching on (x, y, sigma) within tolerance and match the
*behaviour envelope* (>=85% overlap, descriptor cosine >= 0.9), not
bit-exactness.
"""

from __future__ import annotations

import numpy as np


def greedy_keypoint_match(a_xy, b_xy, a_sigma=None, b_sigma=None,
                          tol_px=2.0, tol_sigma_ratio=1.6):
    """Greedy nearest-neighbour matching of two keypoint sets.

    Returns list of (i, j) index pairs, each used at most once.
    """
    a_xy = np.asarray(a_xy, np.float64)
    b_xy = np.asarray(b_xy, np.float64)
    if len(a_xy) == 0 or len(b_xy) == 0:
        return []
    d = np.linalg.norm(a_xy[:, None, :] - b_xy[None, :, :], axis=-1)
    okm = d <= tol_px
    if a_sigma is not None and b_sigma is not None:
        ratio = np.asarray(a_sigma)[:, None] / np.maximum(np.asarray(b_sigma)[None, :], 1e-9)
        okm &= (ratio < tol_sigma_ratio) & (ratio > 1.0 / tol_sigma_ratio)
    d = np.where(okm, d, np.inf)
    pairs = []
    used_b = set()
    order = np.argsort(d.min(axis=1))
    for i in order:
        j = int(np.argmin(d[i]))
        if np.isfinite(d[i, j]) and j not in used_b:
            pairs.append((int(i), j))
            used_b.add(j)
    return pairs


def cosine(a, b, axis=-1):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    num = (a * b).sum(axis)
    den = np.linalg.norm(a, axis=axis) * np.linalg.norm(b, axis=axis)
    return num / np.maximum(den, 1e-12)


def cv2_sift_oracle(img01, n_features=0, contrast=0.04, edge=10, sigma=1.6,
                    with_response=False):
    """Run cv2.SIFT on a [0,1] float image; returns (xy, sigma, angle_rad,
    desc[, response])."""
    import cv2
    u8 = np.clip(img01 * 255.0, 0, 255).astype(np.uint8)
    sift = cv2.SIFT_create(nfeatures=n_features, contrastThreshold=contrast,
                           edgeThreshold=edge, sigma=sigma)
    kps, desc = sift.detectAndCompute(u8, None)
    if not kps:
        out = (np.zeros((0, 2)), np.zeros((0,)), np.zeros((0,)),
               np.zeros((0, 128)))
        return out + (np.zeros((0,)),) if with_response else out
    xy = np.array([k.pt for k in kps], np.float32)
    sig = np.array([k.size * 0.5 for k in kps], np.float32)
    ang = np.array([np.deg2rad(k.angle) for k in kps], np.float32)
    desc = np.asarray(desc, np.float32)
    desc /= np.maximum(np.linalg.norm(desc, axis=-1, keepdims=True), 1e-9)
    if with_response:
        resp = np.array([k.response for k in kps], np.float32)
        return xy, sig, ang, desc, resp
    return xy, sig, ang, desc
