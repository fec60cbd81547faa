"""Synthetic ground-truth scene generators (SURVEY.md §4.3).

No datasets ship with this environment, so geometry tests and the SLAM
regression suite run on rendered scenes with exact ground truth:

* random textured images (Gaussian blob fields) for feature tests,
* homography-warped pairs for two-view tests,
* a planar-scene RGB-D sequence with analytic depth + exact poses for
  SLAM/odometry tests (a plane's image under a pinhole camera is an exact
  homography warp, so rendering is cheap and artifact-free),
* random bundle-adjustment problems for optimiser tests.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy import ndimage

from ..optim.lie import se3_exp

# TUM fr1-like intrinsics (640x480)
DEFAULT_INTR = np.array([517.3, 516.5, 318.6, 255.3], np.float32)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Gaussian blur with mirrored borders and a 4-sigma kernel radius
    (cv2.GaussianBlur's automatic kernel size and BORDER_REFLECT_101)."""
    return ndimage.gaussian_filter(img, sigma, mode="mirror", truncate=4.0)


def warp_perspective(img: np.ndarray, h_mat: np.ndarray, h: int,
                     w: int) -> np.ndarray:
    """[h, w] image of `img` under homography `h_mat` (source -> output).

    Each output pixel reads the source bilinearly at H^-1 (x, y, 1), with
    mirrored borders (cv2.warpPerspective with INTER_LINEAR and
    BORDER_REFLECT_101).
    """
    yy, xx = np.mgrid[0:h, 0:w]
    src = np.linalg.inv(h_mat) @ np.stack(
        [xx.ravel(), yy.ravel(), np.ones(h * w)]).astype(np.float64)
    coords = np.stack([src[1] / src[2], src[0] / src[2]])     # (row, col)
    out = ndimage.map_coordinates(np.asarray(img, np.float32), coords,
                                  order=1, mode="mirror")
    return out.reshape(h, w)


def textured_image(h: int, w: int, seed: int = 0, blobs: int = 160,
                   detail: float = 0.0, detail_octaves: int = 1) -> np.ndarray:
    """Random multi-scale Gaussian-blob texture in [0, 1] (SIFT-friendly).

    detail > 0 adds band-passed noise (corner-rich fine structure) so
    benchmark images reach realistic keypoint densities (~1-2k at 480p).
    detail_octaves > 1 stacks coarser octave-spaced bands on top (1/f-like
    spectrum, as in real photographs) so SIFT octaves above the first see
    extrema too — with a single fine band, octaves 1+ are nearly empty
    (see scripts/yield_probe.py).
    """
    rs = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 0.15 + 0.1 * (xx / w) + 0.1 * (yy / h)
    for _ in range(blobs):
        cx, cy = rs.uniform(0, w), rs.uniform(0, h)
        s = rs.uniform(2.0, 18.0)
        a = rs.uniform(-0.6, 0.8)
        img += a * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
    if detail > 0:
        for o in range(max(1, detail_octaves)):
            noise = rs.normal(size=(h, w)).astype(np.float32)
            band = (gaussian_blur(noise, 1.2 * 2.0 ** o)
                    - gaussian_blur(noise, 3.0 * 2.0 ** o))
            img += detail * band / max(band.std(), 1e-6)
    img = (img - img.min()) / (img.max() - img.min())
    return img.astype(np.float32)


def warped_pair(h: int = 480, w: int = 640, seed: int = 0, blobs: int = 160,
                detail: float = 0.0, detail_octaves: int = 1):
    """(img_a, img_b, H_true) with img_b = warp(img_a, H_true)."""
    img = textured_image(h, w, seed=seed, blobs=blobs, detail=detail,
                         detail_octaves=detail_octaves)
    rs = np.random.default_rng(seed + 1)
    ang = rs.uniform(-0.15, 0.15)
    sc = rs.uniform(0.9, 1.1)
    ca, sa = sc * np.cos(ang), sc * np.sin(ang)
    h_true = np.array([
        [ca, -sa, rs.uniform(-20, 20) + (1 - ca) * w / 2 + sa * h / 2],
        [sa, ca, rs.uniform(-20, 20) - sa * w / 2 + (1 - ca) * h / 2],
        [rs.uniform(-5e-5, 5e-5), rs.uniform(-5e-5, 5e-5), 1.0],
    ], np.float64)
    img_b = warp_perspective(img, h_true, h, w)
    return img, img_b.astype(np.float32), h_true


class RGBDSequence(NamedTuple):
    """Ground-truth RGB-D sequence. Poses are world-to-camera (R, t)."""

    images: np.ndarray     # [F, H, W] float32 in [0, 1]
    depths: np.ndarray     # [F, H, W] float32 metres (0 = invalid)
    poses_r: np.ndarray    # [F, 3, 3]
    poses_t: np.ndarray    # [F, 3]
    intr: np.ndarray       # [4]
    timestamps: np.ndarray  # [F] seconds


def planar_rgbd_sequence(n_frames: int = 12, h: int = 480, w: int = 640,
                         seed: int = 0, plane_depth: float = 2.0,
                         motion_scale: float = 1.0,
                         detail: float = 0.0,
                         depth_noise: float = 0.0) -> RGBDSequence:
    """Camera orbiting in front of a textured plane z = plane_depth (world).

    The plane's image in any camera is an exact homography of the world
    texture, so rendering is a perspective warp and the depth map is
    analytic: z(u, v) = plane-ray intersection.

    depth_noise > 0 perturbs the depth maps with multiplicative Gaussian
    noise of that relative sigma (sensor-like): rigid-RANSAC tracking on
    noisy backprojections accumulates drift, the scenario where windowed
    reprojection BA (whose 2D observations carry no depth error) must
    measurably reduce trajectory error.
    """
    fx, fy, cx, cy = DEFAULT_INTR
    k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
    k_inv = np.linalg.inv(k)
    tex = textured_image(h, w, seed=seed, blobs=260, detail=detail)

    rs = np.random.default_rng(seed + 7)
    images, depths, rots, trans, stamps = [], [], [], [], []
    # world plane: points X = (x, y, plane_depth); texture maps world (x, y)
    # to texture pixels via the reference camera at identity.
    n_w = np.array([0.0, 0.0, 1.0])
    for f in range(n_frames):
        # smooth trajectory: slow sideways arc + small rotation jitter
        s = f / max(n_frames - 1, 1)
        xi = np.array([
            0.35 * np.sin(2 * np.pi * s) * motion_scale,          # tx
            0.15 * np.sin(4 * np.pi * s + 1.0) * motion_scale,    # ty
            0.10 * np.sin(2 * np.pi * s + 0.5) * motion_scale,    # tz
            0.04 * np.sin(2 * np.pi * s + 2.0) * motion_scale,    # wx
            0.08 * np.sin(2 * np.pi * s) * motion_scale,          # wy
            0.03 * np.sin(4 * np.pi * s) * motion_scale,          # wz
        ])
        r_np, t_np = (np.asarray(a) for a in se3_exp(xi))
        # world-to-camera
        r_wc, t_wc = r_np, t_np
        # homography from the reference view (identity cam) to this view for
        # the plane n.X = d (d = plane_depth > 0): H = K (R + t n^T / d) K^-1
        h_mat = k @ (r_wc + np.outer(t_wc, n_w) / plane_depth) @ k_inv
        img_f = warp_perspective(tex, h_mat, h, w)
        # analytic depth: ray r = K^-1 (u,v,1); plane in cam frame:
        # n_c = R n_w, d_c = d - n_w . (R^T t) ... use X_c = R X_w + t
        # world plane: n_w.X_w = plane_depth -> n_c^T X_c = d_c with
        # n_c = R n_w and d_c = plane_depth + n_c . t
        n_c = r_wc @ n_w
        d_c = plane_depth + n_c @ t_wc
        uu, vv = np.meshgrid(np.arange(w), np.arange(h))
        rays = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu, np.float64)], -1)
        denom = rays @ n_c
        depth = np.where(np.abs(denom) > 1e-9, d_c / denom, 0.0)
        depth = np.where(depth > 0.05, depth, 0.0)
        if depth_noise > 0:
            noise = 1.0 + rs.normal(size=depth.shape) * depth_noise
            depth = np.where(depth > 0, np.maximum(depth * noise, 0.0), 0.0)
        images.append(img_f.astype(np.float32))
        depths.append(depth.astype(np.float32))
        rots.append(r_wc)
        trans.append(t_wc)
        stamps.append(f / 30.0)
    return RGBDSequence(images=np.stack(images), depths=np.stack(depths),
                        poses_r=np.stack(rots).astype(np.float32),
                        poses_t=np.stack(trans).astype(np.float32),
                        intr=DEFAULT_INTR.copy(), timestamps=np.array(stamps))


def two_plane_sequence(n_frames: int = 8, h: int = 480, w: int = 640,
                       seed: int = 0, near: float = 3.0, far: float = 6.0,
                       motion_scale: float = 1.0, path: str = "sweep",
                       blur_frames: tuple = (),
                       blur_sigma: float = 5.0,
                       amplitude: float = 1.0) -> RGBDSequence:
    """Monocular test scene: two textured fronto-parallel planes.

    A single plane is a DEGENERATE configuration for the essential matrix
    (its image motion is a pure homography), so monocular-odometry tests
    need real depth structure: the world splits at x = 0 into a near plane
    (z = near, left) and a far plane (z = far, right).  Each plane's image
    is still an exact homography of the world texture, so rendering stays
    warp-based and the depth map stays analytic.  Poses are world-to-camera.

    path="sweep" (default) drifts sideways+forward; path="loop" follows a
    closed circuit that returns to the start pose at the last frame — the
    deliberate-loop soak scenario for loop-closure tests.  `blur_frames`
    (iterable of frame indices) renders those frames heavily low-pass
    filtered: a low-texture burst that starves keypoint extraction and
    breaks the monocular scale chain, the KITTI failure mode that
    scale-recovery tests need.

    `amplitude` scales the TRANSLATION components only.  The default path
    covers a fixed total excursion, so long sequences get vanishing
    per-frame baseline (and hence vanishing triangulation parallax against
    the 3-6 m planes) — long-sequence tests should raise `amplitude`
    roughly with n_frames to keep per-frame motion KITTI-like.
    """
    # scale the fr1-like intrinsics to the render size (principal point
    # must stay centred for small test renders)
    intr = DEFAULT_INTR * np.array([w / 640.0, h / 480.0,
                                    w / 640.0, h / 480.0], np.float32)
    fx, fy, cx, cy = intr
    k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
    k_inv = np.linalg.inv(k)
    # DISTINCT textures per plane: sharing one texture makes half the
    # descriptors alias across planes, which feeds loop-closure retrieval
    # false positives on long runs (real scenes are not self-similar at
    # this level)
    tex = {-1: textured_image(h, w, seed=seed, blobs=300, detail=0.25),
           +1: textured_image(h, w, seed=seed + 101, blobs=300, detail=0.25)}
    n_w = np.array([0.0, 0.0, 1.0])

    blur_set = set(int(b) for b in blur_frames)
    images, depths, rots, trans, stamps = [], [], [], [], []
    for f in range(n_frames):
        r_wc, t_wc = _two_plane_pose(f, n_frames, path, motion_scale,
                                     amplitude)
        img_f, depth_f = _two_plane_render(r_wc, t_wc, tex, intr, h, w,
                                           near, far)
        if f in blur_set:
            img_f = gaussian_blur(img_f.astype(np.float32), blur_sigma)
        images.append(img_f.astype(np.float32))
        depths.append(depth_f.astype(np.float32))
        rots.append(r_wc)
        trans.append(t_wc)
        stamps.append(f / 10.0)
    return RGBDSequence(images=np.stack(images), depths=np.stack(depths),
                        poses_r=np.stack(rots).astype(np.float32),
                        poses_t=np.stack(trans).astype(np.float32),
                        intr=intr, timestamps=np.array(stamps))


def _two_plane_pose(f: int, n_frames: int, path: str, motion_scale: float,
                    amplitude: float):
    """World-to-camera pose of frame f on the sweep/loop trajectory."""
    s = f / max(n_frames - 1, 1)
    if path == "loop":
        # closed circuit: every component returns to 0 at s = 1, with a
        # far excursion mid-sequence (sin(pi s)^2 envelope) plus gentle
        # in-loop wiggle so consecutive pairs keep parallax
        env = np.sin(np.pi * s) ** 2
        xi = np.array([
            0.70 * env * motion_scale,                        # tx out
            0.05 * np.sin(2 * np.pi * s) * motion_scale,      # ty
            0.35 * np.sin(2 * np.pi * s) * motion_scale,      # tz circuit
            0.02 * np.sin(2 * np.pi * s) * motion_scale,
            0.08 * env * motion_scale,
            0.02 * np.sin(4 * np.pi * s) * motion_scale,
        ])
    elif path == "forward":
        # dominant forward motion (the KITTI geometry): image-centre
        # features persist for a large fraction of the approach while
        # per-frame parallax stays strong — the persistent-structure /
        # low-z/b regime the map-anchor and keyframe-referenced tracking
        # surfaces were designed for (VERDICT r3 task 8).  Small lateral
        # and rotational wiggle keeps the essential matrix well-posed.
        xi = np.array([
            0.04 * np.sin(2 * np.pi * s) * motion_scale,
            0.02 * np.sin(4 * np.pi * s + 1.0) * motion_scale,
            -1.00 * s * motion_scale,  # camera centre -R^T t advances
                                       # TOWARD the planes (total approach
                                       # = amplitude*motion_scale; keep it
                                       # under `near`)
            0.01 * np.sin(2 * np.pi * s) * motion_scale,
            0.02 * np.sin(2 * np.pi * s + 0.5) * motion_scale,
            0.01 * np.sin(4 * np.pi * s) * motion_scale,
        ])
    else:
        xi = np.array([
            0.50 * s * motion_scale,                      # dominant sideways
            0.06 * np.sin(2 * np.pi * s) * motion_scale,  # ty
            0.25 * s * motion_scale,                      # forward
            0.02 * np.sin(2 * np.pi * s) * motion_scale,
            0.05 * s * motion_scale,
            0.02 * np.sin(4 * np.pi * s) * motion_scale,
        ])
    xi[:3] *= amplitude
    return tuple(np.asarray(a) for a in se3_exp(xi))


def _two_plane_render(r_wc, t_wc, tex, intr, h, w, near, far):
    """Render the two-plane world from one world-to-camera pose."""
    fx, fy, cx, cy = intr
    k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
    k_inv = np.linalg.inv(k)
    n_w = np.array([0.0, 0.0, 1.0])
    uu, vv = np.meshgrid(np.arange(w), np.arange(h))
    rays = np.stack([(uu - cx) / fx, (vv - cy) / fy,
                     np.ones_like(uu, np.float64)], -1)
    n_c = r_wc @ n_w
    img_f = np.zeros((h, w), np.float32)
    depth_f = np.zeros((h, w), np.float64)
    for plane_d, side in ((near, -1), (far, +1)):
        h_mat = k @ (r_wc + np.outer(t_wc, n_w) / plane_d) @ k_inv
        warp = warp_perspective(tex[side], h_mat, h, w)
        d_c = plane_d + n_c @ t_wc
        denom = rays @ n_c
        z = np.where(np.abs(denom) > 1e-9, d_c / denom, 0.0)
        # world x of the intersection decides which plane owns the pixel
        cam_pts = rays * z[..., None]
        world = (cam_pts - t_wc) @ r_wc          # R^T (X_c - t)
        own = (world[..., 0] * side >= 0) & (z > 0.05)
        img_f = np.where(own, warp, img_f)
        depth_f = np.where(own, z, depth_f)
    return img_f.astype(np.float32), depth_f.astype(np.float32)


class StereoSequence(NamedTuple):
    """Rectified synthetic stereo sequence with left-camera ground truth."""

    images_l: np.ndarray   # [T, H, W] float32 in [0, 1]
    images_r: np.ndarray   # [T, H, W]
    depths: np.ndarray     # [T, H, W] analytic LEFT depth (oracle only)
    poses_r: np.ndarray    # [T, 3, 3] world-to-left-camera
    poses_t: np.ndarray    # [T, 3]
    intr: np.ndarray       # [4] fx fy cx cy (shared by both cameras)
    baseline: float        # metres, right camera at -baseline along cam x
    timestamps: np.ndarray


def two_plane_stereo_sequence(n_frames: int = 8, h: int = 480, w: int = 640,
                              seed: int = 0, near: float = 3.0,
                              far: float = 6.0, motion_scale: float = 1.0,
                              path: str = "sweep", amplitude: float = 1.0,
                              baseline: float = 0.12,
                              blobs: int = 300,
                              detail_octaves: int = 1) -> StereoSequence:
    """Rectified stereo variant of `two_plane_sequence` (KITTI-style rig).

    The right camera shares the left's orientation and sits `baseline`
    metres along its +x axis, so X_right = X_left - [b, 0, 0]: true
    disparity is fx*b/z and rows align exactly — the geometry
    `ops/stereo.py` assumes.  Depth maps are the LEFT camera's analytic
    plane intersections (oracle for stereo-depth accuracy tests; the
    stereo frontend itself never reads them).
    """
    intr = DEFAULT_INTR * np.array([w / 640.0, h / 480.0,
                                    w / 640.0, h / 480.0], np.float32)
    # blobs/detail_octaves tune the keypoint yield (the north-star
    # wall-clock runs want >= 2k keypoints/frame like the bench scene)
    tex = {-1: textured_image(h, w, seed=seed, blobs=blobs, detail=0.25,
                              detail_octaves=detail_octaves),
           +1: textured_image(h, w, seed=seed + 101, blobs=blobs,
                              detail=0.25, detail_octaves=detail_octaves)}
    il, ir, depths, rots, trans, stamps = [], [], [], [], [], []
    tb = np.array([baseline, 0.0, 0.0])
    for f in range(n_frames):
        r_wc, t_wc = _two_plane_pose(f, n_frames, path, motion_scale,
                                     amplitude)
        img_l, depth_l = _two_plane_render(r_wc, t_wc, tex, intr, h, w,
                                           near, far)
        img_r, _ = _two_plane_render(r_wc, t_wc - tb, tex, intr, h, w,
                                     near, far)
        il.append(img_l)
        ir.append(img_r)
        depths.append(depth_l)
        rots.append(r_wc)
        trans.append(t_wc)
        stamps.append(f / 10.0)
    return StereoSequence(images_l=np.stack(il), images_r=np.stack(ir),
                          depths=np.stack(depths),
                          poses_r=np.stack(rots).astype(np.float32),
                          poses_t=np.stack(trans).astype(np.float32),
                          intr=intr, baseline=float(baseline),
                          timestamps=np.array(stamps))


def ba_problem(seed: int = 0, n_cams: int = 6, n_pts: int = 80,
               pixel_noise: float = 0.5, pose_perturb: float = 0.05,
               point_perturb: float = 0.05):
    """Random BA problem + ground truth (cameras ringed around a point cloud).

    Returns (perturbed BAProblem arrays dict, ground-truth dict).
    """
    rs = np.random.default_rng(seed)
    fx, fy, cx, cy = DEFAULT_INTR
    pts = rs.uniform([-1.5, -1.5, 3.0], [1.5, 1.5, 5.0], size=(n_pts, 3))

    rots, trans = [], []
    for c in range(n_cams):
        xi = np.array([
            0.8 * np.sin(2 * np.pi * c / n_cams), 0.3 * np.cos(2 * np.pi * c / n_cams),
            0.1 * rs.normal(),
            0.05 * rs.normal(), 0.05 * rs.normal(), 0.05 * rs.normal()])
        r_np, t_np = (np.asarray(a) for a in se3_exp(xi))
        rots.append(r_np)
        trans.append(t_np)
    rots = np.stack(rots)
    trans = np.stack(trans)

    cam_idx = np.repeat(np.arange(n_cams), n_pts)
    pt_idx = np.tile(np.arange(n_pts), n_cams)
    pc = np.einsum("oij,oj->oi", rots[cam_idx], pts[pt_idx]) + trans[cam_idx]
    uv = np.stack([pc[:, 0] / pc[:, 2] * fx + cx,
                   pc[:, 1] / pc[:, 2] * fy + cy], -1)
    uv += rs.normal(scale=pixel_noise, size=uv.shape)
    in_img = ((uv[:, 0] > 0) & (uv[:, 0] < 640) & (uv[:, 1] > 0)
              & (uv[:, 1] < 480) & (pc[:, 2] > 0.1))

    # perturb initial estimate; cameras 0 and 1 stay exact (gauge anchors:
    # two fixed poses pin the similarity gauge incl. scale)
    rots_p, trans_p = [rots[0], rots[1]], [trans[0], trans[1]]
    for c in range(2, n_cams):
        xi = rs.normal(scale=pose_perturb, size=6)
        dr_np, dt_np = (np.asarray(a) for a in se3_exp(xi))
        rots_p.append(dr_np @ rots[c])
        trans_p.append(dr_np @ trans[c] + dt_np)
    pts_p = pts + rs.normal(scale=point_perturb, size=pts.shape)

    problem = dict(
        poses_r=np.stack(rots_p).astype(np.float32),
        poses_t=np.stack(trans_p).astype(np.float32),
        points=pts_p.astype(np.float32),
        intr=DEFAULT_INTR.copy(),
        cam_idx=cam_idx.astype(np.int32),
        pt_idx=pt_idx.astype(np.int32),
        uv=uv.astype(np.float32),
        w=in_img.astype(np.float32),
    )
    truth = dict(poses_r=rots, poses_t=trans, points=pts)
    return problem, truth


def pose_ring(n: int = 20, drift: float = 0.02, seed: int = 0):
    """Circular trajectory with drifty odometry + one exact loop closure.

    Returns dict with ground-truth poses, noisy initial poses, and edges
    (odometry chain + closure) for pose-graph tests.
    """
    rs = np.random.default_rng(seed)
    radius = 2.0
    rots, trans = [], []
    for i in range(n):
        a = 2 * np.pi * i / n
        # camera on a circle in the xz plane, yaw following the tangent
        xi = np.array([radius * np.cos(a), 0.0, radius * np.sin(a), 0.0, -a, 0.0])
        r_np, t_np = (np.asarray(x) for x in se3_exp(np.array([0.0, 0, 0, 0, -a, 0])))
        rots.append(r_np)
        trans.append(-r_np @ np.array([radius * np.cos(a), 0.0, radius * np.sin(a)]))
    rots = np.stack(rots)
    trans = np.stack(trans)

    edges_i = np.arange(n - 1)
    edges_j = np.arange(1, n)
    meas_r, meas_t = [], []
    for i, j in zip(edges_i, edges_j):
        # T_i * T_j^-1 with noise
        rrel = rots[i] @ rots[j].T
        trel = trans[i] - rrel @ trans[j]
        dr_np, dt_np = (np.asarray(x) for x in se3_exp(rs.normal(scale=drift, size=6)))
        meas_r.append(dr_np @ rrel)
        meas_t.append(dr_np @ trel + dt_np)
    # loop closure n-1 -> 0, exact
    edges_i = np.append(edges_i, n - 1)
    edges_j = np.append(edges_j, 0)
    rrel = rots[n - 1] @ rots[0].T
    meas_r.append(rrel)
    meas_t.append(trans[n - 1] - rrel @ trans[0])

    # initial guess: integrate noisy odometry
    rots_0, trans_0 = [rots[0]], [trans[0]]
    for e in range(n - 1):
        # T_j = T_rel^-1 * T_i with T_rel measured
        rrel, trel = meas_r[e], meas_t[e]
        rj = rrel.T @ rots_0[-1]
        tj = rrel.T @ (trans_0[-1] - trel)
        rots_0.append(rj)
        trans_0.append(tj)

    return dict(
        gt_r=rots.astype(np.float32), gt_t=trans.astype(np.float32),
        init_r=np.stack(rots_0).astype(np.float32),
        init_t=np.stack(trans_0).astype(np.float32),
        edge_i=edges_i.astype(np.int32), edge_j=edges_j.astype(np.int32),
        meas_r=np.stack(meas_r).astype(np.float32),
        meas_t=np.stack(meas_t).astype(np.float32),
        weight=np.ones(n, np.float32),
    )
