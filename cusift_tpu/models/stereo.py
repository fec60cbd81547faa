"""Stereo keyframe SLAM / odometry (KITTI rigs; BASELINE configs[4]).

New surface relative to the reference (SURVEY.md §0): the reference's
geometry stack is depth-assisted (rigid RGB-D alignment, SURVEY.md C15);
a rectified stereo rig SUPPLIES that depth from one descriptor match per
feature (ops/stereo.py: z = fx*b/disparity), so the entire RGB-D SLAM
backend — keyframe ring, loop closure, pose graph, sliding-window BA,
eviction, checkpoint/resume — runs unchanged on stereo pairs with METRIC
scale (no monocular scale ambiguity, no Sim(3) layer needed).

Design: one jitted step per frame — BOTH images extracted as a 2-frame
batch (the batched pipeline the bench measures), left-right match for
depth, left-vs-keyframe match + rigid RANSAC for tracking — with the same
single packed scalar fetch per frame as models/slam.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..config import MatchConfig, RansacConfig, SiftConfig
from ..ops.geometry import backproject
from ..ops.match import match
from ..ops.ransac import find_rigid
from ..ops.stereo import stereo_depth
from ..optim.lie import inverse, se3_log
from .sift import extract_batch
from .slam import Slam


@partial(jax.jit, static_argnames=("sift_cfg", "match_cfg"))
def _extract_stereo_points(img_l, img_r, intr, baseline,
                           sift_cfg: SiftConfig, match_cfg: MatchConfig):
    """Left features + metric 3D backprojections from one rectified pair.

    Both images ride ONE batched extraction (extract_batch) so the
    pyramid/detect/describe stages stay at the bench's batched shape.
    """
    f2 = extract_batch(jnp.stack([img_l, img_r]), sift_cfg)
    fl = jax.tree.map(lambda a: a[0], f2)
    fr = jax.tree.map(lambda a: a[1], f2)
    depth, dok = stereo_depth(fl.desc, fl.valid, fl.x, fl.y,
                              fr.desc, fr.valid, fr.x, fr.y,
                              intr[0], baseline, match_cfg)
    pts = backproject(jnp.stack([fl.x, fl.y], -1), depth,
                      intr[0], intr[1], intr[2], intr[3])
    return fl, pts, dok


@partial(jax.jit, static_argnames=("sift_cfg", "match_cfg", "ransac_cfg"))
def _stereo_chunk_step(frames, intr, baseline,
                       ref_desc, ref_valid, ref_pts,
                       sift_cfg: SiftConfig, match_cfg: MatchConfig,
                       ransac_cfg: RansacConfig, keys):
    """Track a [N, 2, H, W] stereo chunk against ONE reference keyframe.

    The stereo mirror of slam._chunk_step: plane 0 is the left image,
    plane 1 the right (utils/pipeline.py packs (img_l, img_r) pairs
    exactly like (img, depth)).  One dispatch, one packed [N, 22] fetch —
    the host-link amortisation the chunked run exists for.
    """
    def one(fr, k):
        return _stereo_frame_step(fr[0], fr[1], intr, baseline,
                                  ref_desc, ref_valid, ref_pts,
                                  sift_cfg, match_cfg, ransac_cfg, k)

    return jax.vmap(one)(frames, keys)


@partial(jax.jit, static_argnames=("sift_cfg", "match_cfg", "ransac_cfg"))
def _stereo_frame_step(img_l, img_r, intr, baseline,
                       ref_desc, ref_valid, ref_pts,
                       sift_cfg: SiftConfig, match_cfg: MatchConfig,
                       ransac_cfg: RansacConfig, key):
    """One stereo tracking step, packed exactly like slam._frame_step.

    The identical [22]-float layout lets Slam._commit apply verbatim:
    [num_inliers, ok, n_kpts, n_matches, rel_r(9), rel_t(3), xi(6)].
    """
    f, pts, pvalid = _extract_stereo_points(img_l, img_r, intr, baseline,
                                            sift_cfg, match_cfg)
    m = match(f.desc, f.valid, ref_desc, ref_valid, match_cfg)
    pb = ref_pts[m.idx]
    ok = m.ok & pvalid & (pb[:, 2] > 1e-6)
    rig = find_rigid(pts, pb, ok, ransac_cfg, key)
    rel_r, rel_t = inverse(rig.r, rig.t)
    xi = se3_log(rel_r, rel_t)
    packed = jnp.concatenate([
        jnp.array([rig.num_inliers, rig.ok, f.valid.sum(), m.ok.sum()],
                  jnp.float32),
        rel_r.reshape(-1), rel_t, xi,
    ])
    return f, pts, packed


class StereoSlam(Slam):
    """Sequential stereo SLAM driver: Slam with stereo-derived depth.

    `run`/`process_frame` consume (img_left, img_right) pairs instead of
    (img, depth); everything downstream of perception — keyframe policy,
    loop closure, pose-graph optimisation, local BA, eviction,
    checkpoint/resume, trajectory/ATE — is inherited unchanged, at
    metric scale (stereo pins it; cite SURVEY.md §2.4 configs[4]).
    """

    def __init__(self, intr, baseline: float, **kw):
        super().__init__(intr, **kw)
        assert baseline > 0, "rectified rig baseline (metres) required"
        self.baseline = jnp.float32(baseline)

    def _sense(self, img, aux):
        f, pts, dok = _extract_stereo_points(
            jnp.asarray(img), jnp.asarray(aux), self.intr, self.baseline,
            self.sift_cfg, self.match_cfg)
        return f, pts

    def _sense_step(self, img, aux, kd, kv, kp, key):
        return _stereo_frame_step(
            jnp.asarray(img), jnp.asarray(aux), self.intr, self.baseline,
            kd, kv, kp, self.sift_cfg, self.match_cfg, self.ransac_cfg,
            key)

    def _chunk_sense_step(self, fchunk, kd, kv, kp, keys):
        return _stereo_chunk_step(
            fchunk, self.intr, self.baseline, kd, kv, kp, self.sift_cfg,
            self.match_cfg, self.ransac_cfg, keys)
