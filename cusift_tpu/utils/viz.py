"""Visualisation: keypoint and match rendering (reference demo parity).

The reference demo optionally draws matches over the image pair
(SURVEY.md C16); this writes the same overlays as PNGs via OpenCV.
"""

from __future__ import annotations

import numpy as np

from .image import import_cv2


def _to_u8(img01: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(img01) * 255.0, 0, 255).astype(np.uint8)


def draw_keypoints(img01, feats, path: str | None = None):
    """Render valid keypoints as scale-sized circles with orientation ticks."""
    cv2 = import_cv2("drawing keypoints")
    out = cv2.cvtColor(_to_u8(img01), cv2.COLOR_GRAY2BGR)
    v = np.asarray(feats.valid)
    xs, ys = np.asarray(feats.x)[v], np.asarray(feats.y)[v]
    sig = np.asarray(feats.sigma)[v]
    ang = np.asarray(feats.orientation)[v]
    for x, y, s, a in zip(xs, ys, sig, ang):
        c = (int(round(x)), int(round(y)))
        r = max(2, int(round(2 * s)))
        cv2.circle(out, c, r, (0, 200, 0), 1, cv2.LINE_AA)
        tip = (int(round(x + r * np.cos(a))), int(round(y + r * np.sin(a))))
        cv2.line(out, c, tip, (0, 120, 255), 1, cv2.LINE_AA)
    if path:
        cv2.imwrite(path, out)
    return out


def draw_matches(img_a, feats_a, img_b, feats_b, matches,
                 inliers=None, path: str | None = None, max_lines: int = 200):
    """Side-by-side match visualisation (green = inlier, red = outlier)."""
    cv2 = import_cv2("drawing matches")
    a = cv2.cvtColor(_to_u8(img_a), cv2.COLOR_GRAY2BGR)
    b = cv2.cvtColor(_to_u8(img_b), cv2.COLOR_GRAY2BGR)
    h = max(a.shape[0], b.shape[0])
    canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[: a.shape[0], : a.shape[1]] = a
    canvas[: b.shape[0], a.shape[1]:] = b
    off = a.shape[1]

    ok = np.asarray(matches.ok)
    idx = np.asarray(matches.idx)
    inl = np.asarray(inliers) if inliers is not None else ok
    xa, ya = np.asarray(feats_a.x), np.asarray(feats_a.y)
    xb, yb = np.asarray(feats_b.x), np.asarray(feats_b.y)
    rows = np.nonzero(ok)[0][:max_lines]
    for i in rows:
        j = idx[i]
        col = (0, 200, 0) if inl[i] else (0, 0, 220)
        p = (int(round(xa[i])), int(round(ya[i])))
        q = (int(round(xb[j])) + off, int(round(yb[j])))
        cv2.line(canvas, p, q, col, 1, cv2.LINE_AA)
    if path:
        cv2.imwrite(path, canvas)
    return canvas


def save_trajectory_tum(path: str, timestamps, poses_r, poses_t):
    """Write a trajectory in TUM format (t tx ty tz qx qy qz qw, cam-to-world)."""
    from scipy.spatial.transform import Rotation
    poses_r = np.asarray(poses_r)
    poses_t = np.asarray(poses_t)
    with open(path, "w") as f:
        for ts, r_wc, t_wc in zip(np.asarray(timestamps), poses_r, poses_t):
            r_cw = r_wc.T
            t_cw = -r_wc.T @ t_wc
            q = Rotation.from_matrix(r_cw).as_quat()  # x y z w
            f.write(f"{ts:.6f} {t_cw[0]:.6f} {t_cw[1]:.6f} {t_cw[2]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")
