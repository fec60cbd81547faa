"""Monocular visual odometry (KITTI frontend, BASELINE configs[4]).

New surface relative to the reference: cuSIFT's geometry stack is
depth-assisted (homography / RGB-D rigid, SURVEY.md C13-C15), so KITTI's
depth-free grayscale sequences need this module: per-pair essential-matrix
RANSAC (`ops/essential.py`), cheirality-checked decomposition, midpoint
triangulation, and scale-consistent chaining of the per-pair unit
translations via triangulated-depth ratios on features tracked across
three frames (the classic monocular scale-propagation scheme).

Design: ONE jitted program per pair — extract + match + RANSAC +
triangulation + scale estimate — with a single packed fetch per frame
(same host-interface discipline as models/slam.py: the per-frame scalars
ride one small array to the host).  The absolute scale of the whole trajectory is unobservable
from a monocular camera; outputs are metrically consistent up to that one
global factor (evaluation aligns it, data/evaluation.py ``with_scale``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (MatchConfig, PoseGraphConfig, RansacConfig, SiftConfig,
                      VOConfig)
from ..ops.essential import find_essential, triangulate_midpoint
from ..ops.match import match
from ..ops.pnp import find_pnp
from .sift import SiftFeatures, extract


class PairOdometry(NamedTuple):
    """Device-side result of one odometry pair step."""

    feats: SiftFeatures       # frame B features (carried to the next pair)
    r_rel: jnp.ndarray        # [3, 3] with x_b = R x_a + t
    t_rel: jnp.ndarray        # [3] globally-scaled translation
    scale: jnp.ndarray        # scalar applied to the unit translation
    depth: jnp.ndarray        # [N] triangulated depth per frame-B slot
    pts: jnp.ndarray          # [N, 3] frame-B camera-frame points
                              # (triangulated, global scale; z=0 unknown)
    num_inliers: jnp.ndarray  # int32
    scale_common: jnp.ndarray  # int32: tracked points used for the scale
    ok: jnp.ndarray           # bool: a pose was measured this pair
    pnp_used: jnp.ndarray     # bool: essential failed, PnP rescue supplied
                              # the pose (VOConfig.pnp_rescue)


# shared with the map-anchored frontend (models/monomap.py)
from ..ops.geometry import masked_median as _masked_median  # noqa: E402


@partial(jax.jit, static_argnames=("sift_cfg", "match_cfg", "ransac_cfg",
                                   "pnp_rescue"))
def pair_step(desc_a: jnp.ndarray, valid_a: jnp.ndarray,
              xy_a: jnp.ndarray, depth_a: jnp.ndarray,
              img_b: jnp.ndarray, intr: jnp.ndarray,
              prev_scale: jnp.ndarray,
              sift_cfg: SiftConfig = SiftConfig(),
              match_cfg: MatchConfig = MatchConfig(),
              ransac_cfg: RansacConfig = RansacConfig(),
              key: jax.Array | None = None,
              content=None, pnp_rescue: bool = True) -> PairOdometry:
    """One monocular odometry step: previous features + new image.

    depth_a: [N] globally-scaled triangulated depth per frame-A slot from
    the previous pair (0 = unknown; all zeros on the first pair, which
    then anchors the global scale at |t| = 1).  `content`: optional
    traced [2] (h, w) of the true image content when img_b is padded to
    a canonical shape tier.
    """
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    fb = extract(img_b, sift_cfg)
    if content is not None:
        from .twoview import mask_to_content
        fb = mask_to_content(fb, content, sift_cfg.border)
    m = match(desc_a, valid_a, fb.desc, fb.valid, match_cfg)

    xa = jnp.stack([(xy_a[:, 0] - cx) / fx, (xy_a[:, 1] - cy) / fy], -1)
    xb_all = jnp.stack([(fb.x - cx) / fx, (fb.y - cy) / fy], -1)
    xb = xb_all[m.idx]

    if key is None:
        key = jax.random.PRNGKey(ransac_cfg.seed)
    k_ess, k_pnp = jax.random.split(key)
    res = find_essential(xa, xb, m.ok, ransac_cfg, k_ess)
    _, za, zb = triangulate_midpoint(res.r, res.t, xa, xb)
    good = res.inliers & (za > 1e-6) & (zb > 1e-6)

    # scale chaining: features seen in the previous pair carry a global
    # depth in frame A; the fresh triangulation measures the same depth in
    # |t|=1 units, so the ratio's robust median is this pair's scale.
    # za in unit-baseline units IS depth/baseline = inverse parallax: points
    # beyond ~500 carry < ~0.1 deg of parallax and their triangulated depth
    # is noise-dominated with a heavy HIGH tail, which biases the ratio
    # median LOW and decays the chained scale multiplicatively — gate them.
    low_parallax = (za > 500.0) | (zb > 500.0)
    have_prev = good & (depth_a > 1e-6) & ~low_parallax
    ratio = depth_a / jnp.maximum(za, 1e-6)
    n_common = jnp.sum(have_prev.astype(jnp.int32))
    med = _masked_median(ratio, have_prev)
    # NOTE a quantile-restricted median (e.g. nearest-half by za) is NOT a
    # valid robustification here: selecting on the ratio's own denominator
    # selects its noise sign and inflates the median mechanically
    # (measured: chain drift x9 -> x16000 over 70 pairs).  The residual
    # per-pair scale error is COHERENT (every point shares the pair's
    # motion-estimate error), so no per-point aggregation can remove it —
    # bounding the accumulated drift is the loop-closure/Sim(3) layer's job.
    scale_ok = (n_common >= 8) & jnp.isfinite(med) & (med > 1e-6)
    # smooth-motion clamp: consecutive pairs' physical |t| cannot jump an
    # order of magnitude, so a ratio-median far from the previous scale is
    # an estimation failure, not a measurement — bound the per-pair scale
    # step (re-convergence after a real change still proceeds at 3x/pair)
    med = jnp.clip(med, prev_scale / 3.0, prev_scale * 3.0)
    scale = jnp.where(scale_ok, med, prev_scale)

    # PnP rescue (VERDICT r4 task 3): essential fails on sub-SNR frames
    # (the cheirality majority collapses at vanishing parallax) although
    # the MATCHES are fine — re-measure the pose against frame A's
    # chain-scaled triangulated points.  The DLT-PnP pose comes out at
    # the chain's global scale directly, so no scale step is taken and
    # the depth chain transfers exactly (z of R X_a + t), keeping
    # anchors alive for the next pair.  lax.cond keeps the RANSAC out
    # of the healthy-frame path.
    r_sel, t_sel, ok_sel = res.r, res.t * scale, res.ok
    ninl_sel = res.num_inliers
    depth_vals = jnp.where(good, zb * scale, 0.0)
    use_pnp = jnp.bool_(False)
    if pnp_rescue:
        pts_a3 = jnp.concatenate([xa, jnp.ones_like(xa[:, :1])], -1) \
            * depth_a[:, None]
        have3d = m.ok & (depth_a > 1e-6)
        try_pnp = (~res.ok) & (jnp.sum(have3d.astype(jnp.int32))
                               >= ransac_cfg.min_matches)

        def _rescue(k):
            p = find_pnp(pts_a3, xb, have3d, ransac_cfg, k)
            return p.r, p.t, p.ok, p.num_inliers, p.inliers

        def _skip(k):
            return (jnp.eye(3, dtype=xa.dtype), jnp.zeros(3, xa.dtype),
                    jnp.bool_(False), jnp.int32(0),
                    jnp.zeros_like(have3d))

        pr, pt, pok, pnum, pinl = jax.lax.cond(try_pnp, _rescue, _skip,
                                               k_pnp)
        use_pnp = try_pnp & pok
        # depth transfer through the rescued pose — elementwise row-3
        # product (no matmul: a reduced-precision pass would quantise
        # the chain depths)
        zb_pnp = jnp.sum(pts_a3 * pr[2], -1) + pt[2]
        good_pnp = have3d & pinl & (zb_pnp > 1e-6)
        r_sel = jnp.where(use_pnp, pr, r_sel)
        t_sel = jnp.where(use_pnp, pt, t_sel)
        ok_sel = ok_sel | use_pnp
        ninl_sel = jnp.where(use_pnp, pnum, ninl_sel)
        scale = jnp.where(use_pnp, prev_scale, scale)
        depth_vals = jnp.where(use_pnp,
                               jnp.where(good_pnp, zb_pnp, 0.0),
                               depth_vals)

    # per-slot depth of frame B (global units) for the NEXT pair's chain;
    # scatter through the match index, last writer wins on collisions
    # (collisions only happen via cross-matched duplicates; harmless)
    depth_b = jnp.zeros(fb.valid.shape[0], jnp.float32)
    depth_b = depth_b.at[m.idx].set(depth_vals, mode="drop")
    # camera-frame 3D points of frame B from the triangulated depths —
    # the monocular stand-in for RGB-D backprojections; feeds the same
    # windowed BA the SLAM backend uses (models/local_ba.py)
    pts_b = jnp.concatenate([xb_all, jnp.ones_like(xb_all[:, :1])], -1) \
        * depth_b[:, None]

    return PairOdometry(feats=fb, r_rel=r_sel, t_rel=t_sel,
                        scale=scale, depth=depth_b, pts=pts_b,
                        num_inliers=ninl_sel,
                        scale_common=n_common, ok=ok_sel,
                        pnp_used=use_pnp)


@partial(jax.jit, static_argnames=("match_cfg", "ransac_cfg"))
def _loop_verify_step(desc, valid, xyn, depth,
                      kf_desc, kf_valid, kf_xyn, kf_depth,
                      gates,
                      match_cfg: MatchConfig, ransac_cfg: RansacConfig, key):
    """Monocular loop-closure retrieval + essential verification + scales.

    One XLA program, one packed [20] fetch (the host-interface discipline
    of models/slam.py): retrieval scores over the whole keyframe ring, the
    best candidate's ratio-test match, essential RANSAC in normalised
    coordinates, and the TWO depth-ratio scales a Sim(3) loop edge needs:

    * med_b — the candidate keyframe's stored chained depths against the
      fresh |t|=1 triangulation in the candidate frame: the edge
      translation's scale in the CANDIDATE's epoch units;
    * med_a — the current frame's chained depths against the triangulation
      in the current frame: the same physical |t| in the CURRENT epoch.

    Their ratio med_b / med_a is the measured relative scale s_m = k_cand /
    k_cur between the two chain epochs — exactly the scale-drift
    observable the Sim(3) pose graph (optim/sim3graph.py) consumes.

    Keyframes with index in [exclude_lo, limit) are the recent temporal
    neighbours and are excluded from retrieval.  `gates` is a [5] f32
    device array (limit, exclude_lo, min_score, min_inliers, min_common):
    ONE packed upload per keyframe event, not five: each small
    host->device transfer pays a fixed latency.
    """
    from .slam import _kf_scores

    from ..config import replace as cfg_replace
    from ..ops.ransac import find_homography

    limit, exclude_lo = gates[0], gates[1]
    min_score, min_inliers, min_common = gates[2], gates[3], gates[4]
    idx = jnp.arange(kf_desc.shape[0])
    active = (idx < limit) & (idx < exclude_lo)
    scores = _kf_scores(desc, valid, kf_desc, kf_valid, active)
    # verify the TOP-3 retrieval candidates, not just the argmax: the most
    # similar allowed keyframe is often a geometrically-useless mid-range
    # view while the genuine revisit sits a few ranks down (measured: the
    # 300-frame soak's true end-of-loop closure NEVER won the argmax)
    top_scores, top_idx = jax.lax.top_k(scores, 3)

    def verify(cand, k):
        m = match(desc, valid, kf_desc[cand], kf_valid[cand], match_cfg)
        xb = kf_xyn[cand][m.idx]
        ok_m = m.ok & valid
        res = find_essential(xyn, xb, ok_m, ransac_cfg, k)
        # planar-degeneracy guard (the ORB-SLAM H/E model-selection test):
        # a pair whose shared view is one dominant plane satisfies a
        # homography and its essential matrix is unconstrained along a
        # one-parameter family — the soak's worst loop edges (15 deg
        # rotation error at 40+ "inliers") were exactly these.  Reject
        # when H explains almost as many correspondences as E.
        hres = find_homography(
            xyn, xb, ok_m,
            cfg_replace(ransac_cfg,
                        inlier_thresh=2.0 * ransac_cfg.inlier_thresh_epi),
            k)
        planar = (hres.num_inliers.astype(jnp.float32)
                  > 0.85 * jnp.maximum(res.num_inliers.astype(jnp.float32),
                                       1.0))
        _, za, zb = triangulate_midpoint(res.r, res.t, xyn, xb)
        good = res.inliers & (za > 1e-6) & (zb > 1e-6)
        dcand = kf_depth[cand][m.idx]
        have_b = good & (dcand > 1e-6)
        med_b = _masked_median(dcand / jnp.maximum(zb, 1e-6), have_b)
        n_b = jnp.sum(have_b.astype(jnp.int32))
        have_a = good & (depth > 1e-6)
        med_a = _masked_median(depth / jnp.maximum(za, 1e-6), have_a)
        n_a = jnp.sum(have_a.astype(jnp.int32))
        ok = res.ok.astype(jnp.float32) * (1.0 - planar)
        packed = jnp.concatenate([
            jnp.array([cand, scores[cand], ok, res.num_inliers,
                       n_b, med_b, n_a, med_a], jnp.float32),
            res.r.reshape(-1), res.t])
        # acceptance figure of merit: inliers among candidates that pass
        # the SAME gates the host applies to the returned winner
        # (_try_loop_closure) — a looser device gate would let argmax pick
        # a candidate the host then rejects while a passing candidate at
        # rank 2-3 is discarded
        accept = ((ok > 0.5)
                  & (scores[cand] >= min_score)
                  & (res.num_inliers >= min_inliers)
                  & (jnp.minimum(n_b, n_a) >= min_common)
                  & jnp.isfinite(med_b) & (med_b > 1e-6)
                  & jnp.isfinite(med_a) & (med_a > 1e-6))
        merit = (accept.astype(jnp.float32)
                 * res.num_inliers.astype(jnp.float32))
        return packed, merit

    keys = jax.random.split(key, 3)
    packs, merits = [], []
    for c in range(3):
        p, mt = verify(top_idx[c],
                       keys[c])
        valid_c = jnp.isfinite(top_scores[c])
        packs.append(p)
        merits.append(jnp.where(valid_c, mt, -1.0))
    best = jnp.argmax(jnp.stack(merits))
    return jnp.stack(packs)[best]


class MonoVO:
    """Host-side monocular odometry loop over an image iterable.

    Composes world-to-camera poses T_k = T_rel,k ∘ T_{k-1}; on RANSAC
    failure the previous relative motion is repeated (constant-velocity
    fallback) so one bad pair cannot break the chain.

    With a `vo_cfg` (VOConfig), the frontend becomes sequence-scale: frames
    are promoted into a fixed-capacity keyframe ring (descriptors,
    normalised coordinates, chained depths), each new keyframe is checked
    against the map for loop closures (retrieval + essential RANSAC +
    depth-ratio scale, `_loop_verify_step`), and accepted closures trigger
    an SE3 pose-graph optimisation over the keyframes with every frame
    pose rebased through its reference keyframe — the machinery that
    bounds drift on KITTI-length sequences (BASELINE configs[4]).
    """

    def __init__(self, intr: np.ndarray,
                 sift_cfg: SiftConfig = SiftConfig(),
                 match_cfg: MatchConfig = MatchConfig(),
                 ransac_cfg: RansacConfig = RansacConfig(),
                 ba_window: int = 0, ba_every: int = 2,
                 ba_anchor: str = "newest",
                 pad_to_tier: bool = False,
                 vo_cfg: VOConfig | None = None,
                 pg_cfg: PoseGraphConfig = PoseGraphConfig(),
                 dist_ba: bool = False):
        # host copy kept alongside the device array: keyframe promotion and
        # loop verification read fx/fy/cx/cy on host, and fetching them
        # back from the device would be a device round-trip each time
        self._intr_np = np.asarray(intr, np.float32)
        self.intr = jnp.asarray(self._intr_np)
        # canonical shape tiers: arbitrary camera resolutions share one
        # compiled program per tier (utils/image.py); features landing in
        # the zero-pad apron are masked out after extraction
        self.pad_to_tier = pad_to_tier
        self._content = None
        self.sift_cfg = sift_cfg
        self.match_cfg = match_cfg
        self.ransac_cfg = ransac_cfg
        self.ba_window = ba_window       # frames; 0 disables windowed BA
        self.ba_every = max(1, ba_every)
        # landmark anchoring: "newest" or "union" (models/local_ba.py;
        # union forces the single-device path — see SlamConfig.local_ba_anchor)
        self.ba_anchor = ba_anchor
        # distributed windowed BA (BASELINE configs[4]): shard the Schur
        # solve over every available device's "map" axis when asked; the
        # single-device path is the fallback on one chip
        self._ba_mesh = None
        if dist_ba and len(jax.devices()) > 1:
            from ..parallel.mesh import map_mesh
            self._ba_mesh = map_mesh()
        self.poses_r = [np.eye(3, dtype=np.float32)]
        self.poses_t = [np.zeros(3, np.float32)]
        self.stats = []
        self._feats = None
        self._depth = None
        self._scale = jnp.float32(1.0)
        self._last_rel = (np.eye(3, dtype=np.float32),
                          np.zeros(3, np.float32))
        # host-side counter PRNG: an eager jax.random.split is a device
        # dispatch plus fetch per call; distinct (seed, counter) raw
        # threefry keys are independent streams built on the host
        self._seed = ransac_cfg.seed
        self._key_ctr = 0
        # device-constant cache: every small host->device upload pays a
        # fixed latency, so recurring values (ring indices, loop gates,
        # perms) are uploaded once
        self._dev_cache: dict = {}
        # device-side ring of (desc, valid, pts) for windowed BA
        self._ring: list[tuple] = []
        # sequence-scale frontend (keyframes + loop closure + pose graph)
        self.vo_cfg = vo_cfg
        self.pg_cfg = pg_cfg
        self.n_kf = 0
        self.n_kf_total = 0   # keyframes ever inserted: monotonic (n_kf
                              # pins at capacity once eviction starts);
                              # the landmark-map recency epoch
        self.n_closures = 0
        self.n_gate_rejects = 0   # Sim(3) solves refused by sim3_gate
        self.gate_log: list[dict] = []   # per-solve gate observables
        self._kf_frame: list[int] = []   # frame index of each keyframe
        self._frame_ref: list[int] = []  # keyframe index each frame rides on
        self._ema_step = 0.0             # smoothed per-pair |t| (global units)
        if vo_cfg is not None:
            assert not (vo_cfg.map_anchor and vo_cfg.track_ref == "keyframe"), \
                "map_anchor assumes prev-frame relatives (VOConfig.track_ref)"
            # keyframe-referenced tracking state: the pair step's A side
            # (features, global depths, raw pose) frozen at the last
            # keyframe; self._feats stays "current frame" for the
            # keyframe/loop machinery
            self._ref_feats = None
            self._ref_depth = None
            self._ref_pose = None
            kf, n = vo_cfg.max_keyframes, sift_cfg.total_kpts
            self._kf_desc = jnp.zeros((kf, n, 128), jnp.float32)
            self._kf_valid = jnp.zeros((kf, n), bool)
            self._kf_xyn = jnp.zeros((kf, n, 2), jnp.float32)
            self._kf_depth = jnp.zeros((kf, n), jnp.float32)
            # pose-graph edges (host lists, bounded by keyframe count)
            # (i, j, meas_r, meas_t, meas_s, weight)
            self._edges: list[tuple] = []
            if vo_cfg.map_anchor:
                # persistent landmark map + device-side pose state (the
                # pose select runs inside the jitted step — uploading the
                # previous pose per frame would be an upload per frame)
                from .monomap import empty_map
                self._lmap = empty_map(vo_cfg.map_size)
                self._map_inl = None
                self._dev_pose = (jnp.eye(3, dtype=jnp.float32),
                                  jnp.zeros(3, jnp.float32))
                self._dev_rel = (jnp.eye(3, dtype=jnp.float32),
                                 jnp.zeros(3, jnp.float32))

    def _dev(self, key, build):
        """Cached device upload of a recurring small constant."""
        v = self._dev_cache.get(key)
        if v is None:
            v = self._dev_cache[key] = jax.device_put(build())
        return v

    def _next_key(self):
        self._key_ctr += 1
        return jnp.asarray(np.array([self._seed, self._key_ctr],
                                    np.uint32))

    def _extract(self, dimg):
        f = extract(dimg, self.sift_cfg)
        if self._content is not None:
            from .twoview import mask_to_content
            f = mask_to_content(f, jnp.asarray(self._content),
                                self.sift_cfg.border)
        return f

    def process(self, img) -> dict | None:
        """Feed the next grayscale frame ([H, W] float in [0, 1]).

        Accepts a host array, or a DEVICE array pre-uploaded by `run`'s
        prefetcher (the feeder thread hides the upload behind the previous
        frame's compute).
        """
        if isinstance(img, jax.Array):
            dimg = img
        else:
            img = np.asarray(img, np.float32)
            if self.pad_to_tier:
                from ..utils.image import pad_to_tier as _pad
                img, self._content = _pad(img)
            dimg = jnp.asarray(img)
        if self._feats is None:
            self._feats = self._extract(dimg)
            n = self._feats.valid.shape[0]
            self._depth = jnp.zeros(n, jnp.float32)
            if self.ba_window:
                self._ring.append((self._feats.desc, self._feats.valid,
                                   jnp.zeros((n, 3), jnp.float32)))
            if self.vo_cfg is not None:
                self._insert_keyframe()     # frame 0 bootstraps the map
                self._frame_ref.append(0)
            return None
        sub = self._next_key()
        kf_ref = (self.vo_cfg is not None
                  and self.vo_cfg.track_ref == "keyframe")
        if kf_ref:
            fa, depth_a = self._ref_feats, self._ref_depth
        else:
            fa, depth_a = self._feats, self._depth
        content = (jnp.asarray(self._content)
                   if self._content is not None else None)
        out = pair_step(fa.desc, fa.valid, jnp.stack([fa.x, fa.y], -1),
                        depth_a, dimg, self.intr, self._scale,
                        self.sift_cfg, self.match_cfg, self.ransac_cfg, sub,
                        content,
                        pnp_rescue=(self.vo_cfg.pnp_rescue
                                    if self.vo_cfg is not None else True))
        map_mode = self.vo_cfg is not None and self.vo_cfg.map_anchor
        pnp_inl, pnp_ok = 0, False
        map_s_med, map_n_anchor = float("nan"), 0
        if map_mode:
            # persistent-map tracking: PnP against the landmark map with
            # on-device pose selection (models/monomap.py); the chain pose
            # stays the fallback and the fetch stays ONE packed array
            from .monomap import localize_step
            sub2 = self._next_key()
            fb = out.feats
            mt = localize_step(
                fb.desc, fb.valid, fb.x, fb.y, self.intr,
                out.depth, out.pts, out.ok, out.r_rel, out.t_rel,
                out.scale, self._scale,
                self._dev_pose[0], self._dev_pose[1],
                self._dev_rel[0], self._dev_rel[1],
                self._lmap, jnp.int32(self.n_kf_total),
                jnp.int32(self.n_kf_total - self.vo_cfg.map_active_kf),
                jnp.int32(self.vo_cfg.map_min_inliers),
                jnp.int32(self.vo_cfg.map_min_obs),
                jnp.int32(self.vo_cfg.map_min_anchor),
                jnp.float32(self.vo_cfg.map_scale_gain),
                self.match_cfg, self.ransac_cfg, sub2)
            self._lmap = mt.lmap
            self._map_inl = mt.inliers
            self._dev_pose = (mt.pose_r, mt.pose_t)
            self._dev_rel = (mt.rel_r, mt.rel_t)
            self._scale = mt.scale
            packed = np.array(jnp.concatenate([
                jnp.stack([out.num_inliers.astype(jnp.float32),
                           out.scale_common.astype(jnp.float32),
                           out.ok.astype(jnp.float32)]),
                mt.packed]))
            n_inl, n_common, ok = packed[0:3]
            r_new = packed[3:12].reshape(3, 3).astype(np.float32)
            t_new = packed[12:15].astype(np.float32)
            scale, pnp_inl, pnp_ok = (float(packed[15]), int(packed[16]),
                                      bool(packed[17] > 0.5))
            map_s_med, map_n_anchor = float(packed[18]), int(packed[19])
            r_prev, t_prev = self.poses_r[-1], self.poses_t[-1]
            r_rel = r_new @ r_prev.T
            t_rel = t_new - r_rel @ t_prev
            self._last_rel = (r_rel, t_rel)
            self.poses_r.append(r_new)
            self.poses_t.append(t_new)
            self._depth = mt.depth
            ring_entry = (fb.desc, fb.valid & (mt.depth > 1e-6), mt.pts)
        else:
            # one packed fetch for every per-frame scalar (host-link
            # discipline)
            packed = np.array(jnp.concatenate([
                out.r_rel.reshape(-1), out.t_rel,
                jnp.stack([out.scale, out.num_inliers.astype(jnp.float32),
                           out.scale_common.astype(jnp.float32),
                           out.ok.astype(jnp.float32),
                           out.pnp_used.astype(jnp.float32)])]))
            r_rel = packed[:9].reshape(3, 3)
            t_rel = packed[9:12]
            scale, n_inl, n_common, ok = packed[12:16]
            if packed[16] > 0.5:        # PnP rescue supplied this pose
                pnp_ok, pnp_inl = True, int(n_inl)
            r_prev, t_prev = self.poses_r[-1], self.poses_t[-1]
            if kf_ref:
                # rel measures ref(keyframe) -> cur; compose onto the
                # REFERENCE pose and derive the frame-to-frame relative
                # for the constant-velocity fallback
                if ok < 0.5:
                    r_fr, t_fr = self._last_rel
                    r_new = (r_fr @ r_prev).astype(np.float32)
                    t_new = (r_fr @ t_prev + t_fr).astype(np.float32)
                else:
                    ref_r, ref_t = self._ref_pose
                    r_new = (r_rel @ ref_r).astype(np.float32)
                    t_new = (r_rel @ ref_t + t_rel).astype(np.float32)
                    r_fr = r_new @ r_prev.T
                    self._last_rel = (r_fr, t_new - r_fr @ t_prev)
                    # adopt the DEVICE-resident scale: re-uploading the
                    # fetched float would be one more upload per frame
                    self._scale = out.scale
                self.poses_r.append(r_new)
                self.poses_t.append(t_new)
                # the REFERENCE's depth chain is trusted regardless of this
                # pair's outcome; the CURRENT frame's depths (vs-ref
                # triangulation, wide parallax) feed the keyframe/loop
                # machinery and the BA ring only when the pair held
                self._depth = (out.depth if ok > 0.5
                               else jnp.zeros_like(out.depth))
            else:
                if ok < 0.5:
                    r_rel, t_rel = self._last_rel  # constant-velocity
                else:
                    self._last_rel = (r_rel, t_rel)
                    # device-resident scale (no per-frame re-upload)
                    self._scale = out.scale
                self.poses_r.append((r_rel @ r_prev).astype(np.float32))
                self.poses_t.append(
                    (r_rel @ t_prev + t_rel).astype(np.float32))
                # depths triangulated from a REJECTED essential model are
                # garbage: zero the carried chain so the scale re-anchors
                # from the next successful pair instead of chaining through
                # the bad model, and keep the frame's BA observations
                # masked out too
                self._depth = (out.depth if ok > 0.5
                               else jnp.zeros_like(out.depth))
            ring_entry = (out.feats.desc,
                          out.feats.valid & (out.depth > 1e-6)
                          & jnp.bool_(ok > 0.5), out.pts)
        # per-FRAME step: in keyframe-referenced mode t_rel spans ref->cur,
        # so the smoothed step must read the frame-to-frame relative
        step = float(np.linalg.norm(self._last_rel[1] if kf_ref else t_rel))
        self._ema_step = (step if self._ema_step == 0.0
                          else 0.8 * self._ema_step + 0.2 * step)
        self._feats = out.feats
        if self.ba_window:
            self._ring.append(ring_entry)
            self._ring = self._ring[-self.ba_window:]
            if (len(self._ring) == self.ba_window
                    and (len(self.poses_r) - 1) % self.ba_every == 0):
                self._window_ba()
        loop = False
        if self.vo_cfg is not None:
            self._frame_ref.append(max(self.n_kf - 1, 0))
            # keyframe-referenced mode never promotes a failed frame: the
            # promoted frame becomes the next tracking reference, and a
            # constant-velocity pose with zeroed depths would poison every
            # pair until the following promotion
            if not kf_ref or ok >= 0.5:
                loop = self._maybe_keyframe()
        stat = dict(inliers=int(n_inl), scale=float(scale),
                    scale_common=int(n_common), ok=bool(ok > 0.5),
                    pnp_inliers=pnp_inl, pnp_ok=pnp_ok,
                    map_s_med=map_s_med, map_n_anchor=map_n_anchor,
                    keyframe=bool(self.vo_cfg is not None and self._kf_frame
                                  and self._kf_frame[-1]
                                  == len(self.poses_r) - 1),
                    loop=loop)
        self.stats.append(stat)
        return stat

    # ---------- sequence-scale frontend (keyframes / loops / pose graph) ----

    def _evict_keyframe(self):
        """Free one keyframe-ring slot; returns the evicted slot or None.

        Mirrors models/slam.py:_evict_keyframe: "redundant" thins the
        densest stretch of camera centres (raw-chain centres — scale drift
        skews distances but only the RANKING matters) with loop-anchored
        nodes soft-penalised, "oldest" is FIFO.  Slot 0 (the gauge origin)
        and the newest 2 slots (the loop-verify reference neighbourhood)
        are never evicted.
        """
        from .evict import select_victim
        victim = select_victim(
            self.vo_cfg.kf_evict, self._kf_pose_r, self._kf_pose_t,
            self.n_kf, guard=2,
            edges=((e[0], e[1], e[5]) for e in self._edges))
        if victim is None:
            return None
        self._remove_keyframe_slot(victim)
        return victim

    def _remove_keyframe_slot(self, v: int):
        """Remove ring slot v, shifting slots above it down by one.

        Index order stays temporal (the loop temporal gap assumes it).
        Frames riding v inherit the PREVIOUS keyframe's correction:
        `trajectory()` re-derives each frame's relative pose from the raw
        chain, so any reference decomposes exactly — only the Sim(3)
        correction lineage changes.  The victim's in/out edges compose
        into one Sim(3) constraint (scales multiply, translations carry
        the upstream scale); other incident edges are dropped.  Landmark
        `seen` epochs in the optional map anchor are keyframe indices and
        are NOT remapped — they only feed a recency window, where an
        off-by-one after eviction is harmless.
        """
        self._frame_ref = [r - 1 if r > v else (v - 1 if r == v else r)
                           for r in self._frame_ref]
        ins = [e for e in self._edges if e[1] == v and e[0] != v]
        outs = [e for e in self._edges if e[0] == v and e[1] != v]
        spliced = None
        if ins and outs:
            a, b = ins[0], outs[0]
            if a[0] != b[1]:
                # X_a = s1 R1 X_v + t1 and X_v = s2 R2 X_b + t2 compose to
                # X_a = (s1 s2)(R1 R2) X_b + s1 R1 t2 + t1
                spliced = (a[0], b[1], a[2] @ b[2],
                           a[4] * (a[2] @ b[3]) + a[3],
                           a[4] * b[4], min(a[5], b[5]))

        def shift(x):
            return x - 1 if x > v else x

        self._edges = [(shift(e[0]), shift(e[1])) + e[2:]
                       for e in self._edges if e[0] != v and e[1] != v]
        if spliced is not None:
            self._edges.append((shift(spliced[0]), shift(spliced[1]))
                               + spliced[2:])

        kfcap = self.vo_cfg.max_keyframes
        perm = np.concatenate(
            [np.arange(v), np.arange(v + 1, kfcap), [v]]).astype(np.int32)
        dperm = self._dev(("perm", v, kfcap), lambda: perm)
        self._kf_desc = self._kf_desc[dperm]
        self._kf_valid = self._kf_valid[dperm]
        self._kf_xyn = self._kf_xyn[dperm]
        self._kf_depth = self._kf_depth[dperm]
        self._kf_pose_r = self._kf_pose_r[perm].copy()
        self._kf_pose_t = self._kf_pose_t[perm].copy()
        del self._kf_frame[v]
        if getattr(self, "_corr", None) is not None:
            cr, ct, cs = self._corr
            self._corr = (np.concatenate([cr[perm[:-1]],
                                          np.eye(3, dtype=cr.dtype)[None]]),
                          np.concatenate([ct[perm[:-1]],
                                          np.zeros((1, 3), ct.dtype)]),
                          np.concatenate([cs[perm[:-1]],
                                          np.ones(1, cs.dtype)]))
        self.n_kf -= 1

    def _insert_keyframe(self) -> bool:
        """Promote the current frame into the keyframe ring.

        Stores descriptors, normalised image coordinates, and the chained
        global-scale depths; adds the odometry pose-graph edge to the
        previous keyframe.  At capacity a slot is evicted first
        (`vo_cfg.kf_evict`); with eviction off, odometry continues
        without map growth (both tested at ring overflow).
        """
        i = self.n_kf
        if i >= self.vo_cfg.max_keyframes:
            if self._evict_keyframe() is None:
                return False
            i = self.n_kf
        f = self._feats
        fx, fy, cx, cy = (float(v) for v in self._intr_np)
        xyn = jnp.stack([(f.x - cx) / fx, (f.y - cy) / fy], -1)
        # dynamic index (device scalar): a Python int would be baked into
        # the compiled update as a constant, recompiling once per ring row
        # — ~max_keyframes compiles over a long run.  Cached: no fresh
        # upload per insert.
        di = self._dev(("i32", i), lambda: np.int32(i))
        self._kf_desc = self._kf_desc.at[di].set(f.desc)
        self._kf_valid = self._kf_valid.at[di].set(f.valid)
        self._kf_xyn = self._kf_xyn.at[di].set(xyn)
        self._kf_depth = self._kf_depth.at[di].set(self._depth)
        if i == 0:
            self._kf_pose_r = np.broadcast_to(
                np.eye(3, dtype=np.float32),
                (self.vo_cfg.max_keyframes, 3, 3)).copy()
            self._kf_pose_t = np.zeros((self.vo_cfg.max_keyframes, 3),
                                       np.float32)
        r_new, t_new = self.poses_r[-1], self.poses_t[-1]
        self._kf_pose_r[i] = r_new
        self._kf_pose_t[i] = t_new
        if i > 0:
            # odometry edge prev -> i measured T_prev * T_i^-1 (relative
            # scale 1: consecutive keyframes share the chain epoch)
            r_prev, t_prev = self._kf_pose_r[i - 1], self._kf_pose_t[i - 1]
            m_r = r_prev @ r_new.T
            m_t = t_prev - m_r @ t_new
            self._edges.append((i - 1, i, m_r, m_t, 1.0, 1.0))
        if getattr(self, "_corr", None) is not None and i > 0:
            # compose the new keyframe onto the CORRECTED map: a slot
            # inserted after the last Sim(3) solve would otherwise hold
            # an identity correction row, and every frame riding it
            # composes relative-as-absolute garbage (measured: the
            # 1000-frame soak's corrected tail).  Inherit the
            # predecessor's correction through the raw relative motion:
            # corrected_i = (R_rel, t_rel/cs_{i-1}) ∘ corrected_{i-1},
            # stored in the (cr, ct, cs) chart trajectory() composes.
            cr, ct, cs = self._corr
            r_rel = r_new @ self._kf_pose_r[i - 1].T
            t_rel = t_new - r_rel @ self._kf_pose_t[i - 1]
            cr[i] = r_rel @ cr[i - 1]
            ct[i] = r_rel @ ct[i - 1] + t_rel
            cs[i] = cs[i - 1]
        self._kf_frame.append(len(self.poses_r) - 1)
        self.n_kf = i + 1
        self.n_kf_total += 1
        if self.vo_cfg.map_anchor:
            # triangulated (map-scale) depths of this keyframe become new
            # landmarks; slots that just localised against the map are
            # excluded (they ARE existing landmarks)
            from .monomap import insert_step
            inl = (self._map_inl if self._map_inl is not None
                   else jnp.zeros(f.valid.shape[0], bool))
            self._lmap = insert_step(
                self._lmap, f.desc, f.valid, f.response, f.x, f.y,
                self.intr, self._depth, inl,
                self._dev_pose[0], self._dev_pose[1],
                jnp.int32(self.n_kf_total),
                self.vo_cfg.map_insert_budget)
        if self.vo_cfg.track_ref == "keyframe":
            # the promoted frame becomes the tracking reference: its
            # features, global-scale depths, and raw pose freeze as the
            # pair step's A side until the next promotion
            self._ref_feats = f
            self._ref_depth = self._depth
            self._ref_pose = (np.array(r_new), np.array(t_new))
            # the next pair spans ONE frame from the fresh reference: seed
            # the smooth-motion scale clamp with the per-frame step, not
            # the wide ref->cur scale it just left (1.0 at bootstrap = the
            # |t01| = 1 global anchor)
            self._scale = jnp.float32(self._ema_step
                                      if self._ema_step > 0 else 1.0)
        return True

    def _maybe_keyframe(self) -> bool:
        """Keyframe promotion + loop closure; returns True on a closure."""
        cfg = self.vo_cfg
        if self.n_kf == 0:
            self._insert_keyframe()
            return False
        if cfg.track_ref == "keyframe" and self.n_kf == 1:
            # force the SECOND keyframe on the first tracked frame: until
            # the reference carries triangulated depth, every pair's scale
            # rides the |t|=1 anchor and cannot measure the growing
            # ref->cur baseline
            if not self._insert_keyframe():
                return False
            self._frame_ref[-1] = self.n_kf - 1
            return self._try_loop_closure()
        last = self._kf_frame[-1]
        cur = len(self.poses_r) - 1
        r_kf, t_kf = self._kf_pose_r[self.n_kf - 1], \
            self._kf_pose_t[self.n_kf - 1]
        r_cur, t_cur = self.poses_r[-1], self.poses_t[-1]
        rel = r_cur @ r_kf.T
        ang = float(np.arccos(np.clip((np.trace(rel) - 1) / 2, -1.0, 1.0)))
        c_kf = -(r_kf.T @ t_kf)
        c_cur = -(r_cur.T @ t_cur)
        dist = float(np.linalg.norm(c_cur - c_kf))
        # translation gate in multiples of the smoothed per-pair step: the
        # monocular global scale is arbitrary, so absolute thresholds would
        # promote every frame or no frame depending on the scale anchor
        trans_gate = cfg.kf_min_translation * max(self._ema_step, 1e-12)
        if (cur - last < cfg.kf_every and ang < cfg.kf_min_rotation
                and dist < trans_gate):
            return False
        if not self._insert_keyframe():
            return False
        self._frame_ref[-1] = self.n_kf - 1
        return self._try_loop_closure()

    def _try_loop_closure(self) -> bool:
        """Retrieve + verify + Sim(3)-optimise for the newest keyframe."""
        cfg = self.vo_cfg
        j = self.n_kf - 1
        exclude_lo = j - cfg.loop_temporal_gap
        if exclude_lo <= 0:
            return False
        sub = self._next_key()
        f = self._feats
        fx, fy, cx, cy = (float(v) for v in self._intr_np)
        xyn = jnp.stack([(f.x - cx) / fx, (f.y - cy) / fy], -1)
        gates = self._dev(("loopgate", j, exclude_lo), lambda: np.array(
            [j, exclude_lo, cfg.loop_min_score, cfg.loop_min_inliers,
             cfg.loop_min_common], np.float32))
        packed = np.asarray(_loop_verify_step(
            f.desc, f.valid, xyn, self._depth,
            self._kf_desc, self._kf_valid, self._kf_xyn, self._kf_depth,
            gates, self.match_cfg, self.ransac_cfg, sub))
        cand, score, ok, inl = (int(packed[0]), float(packed[1]),
                                bool(packed[2] > 0.5), int(packed[3]))
        n_b, med_b, n_a, med_a = (int(packed[4]), float(packed[5]),
                                  int(packed[6]), float(packed[7]))
        if (not ok or not np.isfinite(score) or score < cfg.loop_min_score
                or inl < cfg.loop_min_inliers
                or min(n_b, n_a) < cfg.loop_min_common
                or not np.isfinite(med_b) or med_b <= 1e-6
                or not np.isfinite(med_a) or med_a <= 1e-6):
            return False
        r = packed[8:17].reshape(3, 3)
        # Sim(3) edge cand -> j: X_cand = s_m R X_j + t with the relative
        # epoch scale s_m = k_cand / k_cur and t in the candidate's epoch
        self._edges.append((cand, j, r.astype(np.float32),
                            (packed[17:20] * med_b).astype(np.float32),
                            med_b / med_a, 2.0))
        self.n_closures += 1
        self._optimize_graph()
        return True

    @staticmethod
    def _speed_dispersion(pose_r: np.ndarray, pose_t: np.ndarray,
                          scales: np.ndarray | None,
                          frames: list[int]) -> float:
        """Std of log per-keyframe-segment camera speed (gate observable).

        Speed = distance between consecutive keyframe camera centres per
        frame of temporal gap.  With `scales`, centres come from the
        CORRECTED similarity (R_i, t_i / s_i) — exactly the keyframe poses
        `trajectory()` emits.  The physical prior: camera speed varies
        slowly, so a genuine scale-drift correction makes the log-speed
        profile MORE uniform, while a correction built on poisoned scale
        observables (coherent chain-collapse error) makes it wildly less
        uniform.
        """
        n = len(frames)
        if n < 5:
            return 0.0
        t = pose_t[:n] / (np.maximum(scales[:n], 1e-12)[:, None]
                          if scales is not None else 1.0)
        c = -np.einsum("nij,nj->ni", np.transpose(pose_r[:n], (0, 2, 1)), t)
        gaps = np.maximum(np.diff(np.asarray(frames, np.float64)), 1.0)
        v = np.linalg.norm(np.diff(c, axis=0), axis=1) / gaps
        v = v[v > 1e-12]
        if v.size < 4:
            return 0.0
        return float(np.std(np.log(v)))

    @staticmethod
    def _correction_roughness(pose_r: np.ndarray, pose_t: np.ndarray,
                              corr: tuple, frames: list[int]) -> float:
        """Roughness of the speed modification a correction applies.

        Per keyframe segment: d_k = log(v_corr_k) - log(v_raw_k).  True
        camera motion cancels exactly in the ratio, so this observable is
        MOTION-FREE — a genuinely non-uniform (stop-and-go) speed profile
        contributes nothing, unlike the absolute log-speed dispersion.
        Genuine scale-drift corrections modify speeds smoothly (drift is
        a slow multiplicative random walk, and a loop solve spreads the
        counter-ramp over the whole chain), so diff(d) stays small; a
        poisoned chain-collapse correction jumps by ~e^2 within a couple
        of keyframes.  Returns std(diff(d)); 0.0 when too short.
        """
        n = len(frames)
        if n < 5:
            return 0.0
        cr, ct, cs = corr
        t_raw = pose_t[:n]
        c_raw = -np.einsum("nij,nj->ni",
                           np.transpose(pose_r[:n], (0, 2, 1)), t_raw)
        t_cor = ct[:n] / np.maximum(cs[:n], 1e-12)[:, None]
        c_cor = -np.einsum("nij,nj->ni",
                           np.transpose(cr[:n], (0, 2, 1)), t_cor)
        v_raw = np.linalg.norm(np.diff(c_raw, axis=0), axis=1)
        v_cor = np.linalg.norm(np.diff(c_cor, axis=0), axis=1)
        ok = (v_raw > 1e-12) & (v_cor > 1e-12)
        if np.count_nonzero(ok) < 4:
            return 0.0
        d = np.log(v_cor[ok]) - np.log(v_raw[ok])
        return float(np.std(np.diff(d)))

    def _gate_accept(self, sig_raw: float, sig_corr: float,
                     sig_delta: float) -> bool:
        """Sim(3) solve health decision (VOConfig.sim3_gate).

        Two independent acceptance routes — reject only when BOTH say
        unhealthy:
          * speed: the corrected chain's log-speed dispersion must not
            exceed raw's by sim3_gate_margin (the smooth-motion prior;
            catches wild corrections, and accepts genuinely-abrupt fixes
            like the blur-burst scale re-lock because those make speed
            MORE uniform);
          * smoothness: the correction's own motion-free modification
            roughness stays under sim3_gate_smooth (accepts genuine
            corrections on stop-and-go scenes where drift coincidentally
            smoothed the raw profile, which the speed route alone would
            falsely reject).
        """
        if self.vo_cfg.sim3_gate != "speed":
            return True
        speed_ok = (sig_raw <= 0.0
                    or sig_corr <= sig_raw * self.vo_cfg.sim3_gate_margin)
        smooth_ok = sig_delta <= self.vo_cfg.sim3_gate_smooth
        return speed_ok or smooth_ok

    def _optimize_graph(self):
        """Sim(3) pose graph over the raw keyframe chain.

        The RAW odometry layer (self.poses_r/t, keyframe snapshots, edge
        measurements) is never rewritten: every solve starts from the raw
        chain with unit node scales, so repeated closures re-derive — not
        re-apply — the correction.  The result is stored as a correction
        (per-keyframe similarity) that `trajectory()` composes on output:
        corrected keyframe pose (R_i, t_i / s_i), frame poses rebased
        through their reference keyframe with the local translation
        converted out of its raw epoch (rel_t / s_ref).

        Each solve must pass the `sim3_gate` health check before it is
        stored (VOConfig.sim3_gate): a rejected solve keeps the last
        ACCEPTED correction, so one poisoned closure can never make the
        output trajectory worse than what the engine already had.
        """
        from ..optim.sim3graph import Sim3Graph, optimize as sim3_optimize

        # pad the edge arrays to a static bucket (multiple of 64, weight-0
        # identity padding): without this every closure changes the edge
        # COUNT and recompiles the whole LM/CG program — ~one multi-second
        # CPU compile per closure, unbounded compile-cache growth on long
        # runs (the 300-frame soak OOMed exactly this way)
        e = len(self._edges)
        cap = max(64, -(-e // 64) * 64)
        pad = cap - e
        eye = np.broadcast_to(np.eye(3, dtype=np.float32), (pad, 3, 3))
        ei = np.concatenate([np.array([x[0] for x in self._edges], np.int32),
                             np.zeros(pad, np.int32)])
        ej = np.concatenate([np.array([x[1] for x in self._edges], np.int32),
                             np.zeros(pad, np.int32)])
        mr = np.concatenate([np.stack([x[2] for x in self._edges]), eye])
        mt = np.concatenate([np.stack([x[3] for x in self._edges]),
                             np.zeros((pad, 3), np.float32)])
        ms = np.concatenate([np.array([x[4] for x in self._edges],
                                      np.float32), np.ones(pad, np.float32)])
        wt = np.concatenate([np.array([x[5] for x in self._edges],
                                      np.float32), np.zeros(pad, np.float32)])
        # TWO packed uploads (int + float) instead of eight: each small
        # host->device transfer pays a fixed latency, per closure
        kf = self._kf_pose_r.shape[0]
        iblob = jnp.asarray(np.concatenate([ei, ej]))
        fblob = jnp.asarray(np.concatenate(
            [self._kf_pose_r.ravel(), self._kf_pose_t.ravel(),
             mr.ravel(), mt.ravel(), ms, wt]).astype(np.float32))
        o = 0

        def take(count, shape):
            nonlocal o
            out = fblob[o:o + count].reshape(shape)
            o += count
            return out

        g = Sim3Graph(
            poses_r=take(kf * 9, (kf, 3, 3)),
            poses_t=take(kf * 3, (kf, 3)),
            poses_s=self._dev(("ones", kf), lambda: np.ones(kf, np.float32)),
            edge_i=iblob[:cap], edge_j=iblob[cap:],
            meas_r=take(cap * 9, (cap, 3, 3)),
            meas_t=take(cap * 3, (cap, 3)),
            meas_s=take(cap, (cap,)), weight=take(cap, (cap,)))
        res = sim3_optimize(g, self.pg_cfg)
        packed = np.array(jnp.concatenate([
            res.poses_r.reshape(-1), res.poses_t.reshape(-1), res.poses_s]))
        kf = self._kf_pose_r.shape[0]
        corr = (packed[:kf * 9].reshape(kf, 3, 3),
                packed[kf * 9:kf * 12].reshape(kf, 3),
                packed[kf * 12:])
        sig_raw = self._speed_dispersion(self._kf_pose_r, self._kf_pose_t,
                                         None, self._kf_frame)
        sig_corr = self._speed_dispersion(corr[0], corr[1], corr[2],
                                          self._kf_frame)
        sig_delta = self._correction_roughness(
            self._kf_pose_r, self._kf_pose_t, corr, self._kf_frame)
        accept = self._gate_accept(sig_raw, sig_corr, sig_delta)
        self.gate_log.append(dict(frame=len(self.poses_r) - 1,
                                  sig_raw=round(sig_raw, 4),
                                  sig_corr=round(sig_corr, 4),
                                  sig_delta=round(sig_delta, 4),
                                  accept=bool(accept)))
        if accept:
            self._corr = corr
        else:
            self.n_gate_rejects += 1

    def trajectory(self) -> tuple:
        """Per-frame world-to-camera poses with the latest loop correction.

        Without closures this is the raw odometry chain.  With a stored
        Sim(3) correction, keyframe i maps to the SE(3) pose
        (R_i, t_i / s_i) and every frame rides its reference keyframe with
        its raw relative translation brought into the corrected epoch.
        """
        if getattr(self, "_corr", None) is None:
            return np.stack(self.poses_r), np.stack(self.poses_t)
        cr, ct, cs = self._corr
        rs, ts = [], []
        for k, ref in enumerate(self._frame_ref):
            r_kf, t_kf = self._kf_pose_r[ref], self._kf_pose_t[ref]
            rel_r = self.poses_r[k] @ r_kf.T
            rel_t = (self.poses_t[k] - rel_r @ t_kf) / max(cs[ref], 1e-12)
            r_c, t_c = cr[ref], ct[ref] / max(cs[ref], 1e-12)
            rs.append((rel_r @ r_c).astype(np.float32))
            ts.append((rel_r @ t_c + rel_t).astype(np.float32))
        return np.stack(rs), np.stack(ts)

    def _window_ba(self):
        """Bundle-adjust the last W frames over triangulated landmarks.

        The exact windowed-BA step the RGB-D SLAM backend runs
        (models/local_ba.py) with the monocular triangulated depths
        standing in for RGB-D backprojections; the two oldest window
        poses anchor the (scale-inclusive) gauge, so the chained
        monocular scale is preserved rather than re-ambiguated.
        """
        from .local_ba import window_ba
        from ..config import BAConfig

        w = self.ba_window
        kd = jnp.stack([r[0] for r in self._ring])
        kv = jnp.stack([r[1] for r in self._ring])
        kp = jnp.stack([r[2] for r in self._ring])
        idxs = np.arange(len(self.poses_r) - w, len(self.poses_r))
        # ONE packed upload for the window poses, every ba_every frames
        blob = jnp.asarray(np.concatenate(
            [np.stack([self.poses_r[i] for i in idxs]).ravel(),
             np.stack([self.poses_t[i] for i in idxs]).ravel()]
        ).astype(np.float32))
        r0 = blob[:w * 9].reshape(w, 3, 3)
        t0 = blob[w * 9:].reshape(w, 3)
        ones = self._dev(("ones", w), lambda: np.ones(w, np.float32))
        ba_cfg = BAConfig(max_iters=4, cg_iters=12, num_fixed_poses=2,
                          huber_delta=4.0)
        if self._ba_mesh is not None and self.ba_anchor == "newest":
            from ..parallel.dist_ba import window_ba_dist
            r, t, c0, c1 = window_ba_dist(
                kd, kv, kp, r0, t0, self.intr, ones,
                self._ba_mesh, self.match_cfg, ba_cfg)
        else:
            # union anchoring is single-device only (see
            # SlamConfig.local_ba_anchor rationale in config.py)
            r, t, c0, c1 = window_ba(
                kd, kv, kp, r0, t0, self.intr, ones,
                self.match_cfg, ba_cfg, anchor=self.ba_anchor)
        packed = np.array(jnp.concatenate([r.reshape(-1), t.reshape(-1)]))
        rs = packed[:w * 9].reshape(w, 3, 3)
        ts = packed[w * 9:].reshape(w, 3)
        for k, i in enumerate(idxs):
            self.poses_r[i] = rs[k].astype(np.float32)
            self.poses_t[i] = ts[k].astype(np.float32)
        # keyframe-referenced tracking composes every future pose from the
        # FROZEN reference pose: when BA just adjusted the reference
        # frame, refresh the frozen copy or the next frame's composition
        # silently reverts the correction
        if (self.vo_cfg is not None and self.vo_cfg.track_ref == "keyframe"
                and self._kf_frame and self._kf_frame[-1] in set(idxs)):
            f_idx = self._kf_frame[-1]
            self._ref_pose = (self.poses_r[f_idx].copy(),
                              self.poses_t[f_idx].copy())
        self._last_ba = (float(c0), float(c1))
        if self.vo_cfg is not None and self.vo_cfg.map_anchor:
            # BA rewrote the newest pose: refresh the device pose state
            # (one small upload per BA call, amortised over ba_every
            # frames — the per-frame path never uploads)
            self._dev_pose = (jnp.asarray(self.poses_r[-1]),
                              jnp.asarray(self.poses_t[-1]))

    # ---------- checkpoint / resume (SURVEY.md §5.4, configs[4] path) ----

    def checkpoint(self, path: str):
        """Serialise the full tracking state to one npz (mid-run restart).

        Mirrors models/slam.py: everything the chain needs to continue —
        current-frame features + global depths, scale state, keyframe
        ring, pose-graph edges, Sim(3) correction, BA ring — lands in one
        file; `stats` is metrics, not state, and is not saved.
        """
        d = dict(
            poses_r=np.stack(self.poses_r), poses_t=np.stack(self.poses_t),
            scale=np.float32(self._scale),
            last_rel_r=self._last_rel[0], last_rel_t=self._last_rel[1],
            ema_step=np.float32(self._ema_step),
            key=np.array([self._seed, self._key_ctr], np.uint32),
            depth=np.asarray(self._depth),
            feats=np.concatenate([np.asarray(f, np.float32).reshape(
                len(self._feats.x), -1) for f in self._feats], axis=-1),
            ring_n=len(self._ring),
        )
        for k, (rd, rv, rp) in enumerate(self._ring):
            d[f"ring_desc_{k}"] = np.asarray(rd)
            d[f"ring_valid_{k}"] = np.asarray(rv)
            d[f"ring_pts_{k}"] = np.asarray(rp)
        if self.vo_cfg is not None:
            e = self._edges
            d.update(
                n_kf=self.n_kf, n_kf_total=self.n_kf_total,
                n_closures=self.n_closures,
                kf_frame=np.array(self._kf_frame, np.int32),
                frame_ref=np.array(self._frame_ref, np.int32),
                kf_desc=np.asarray(self._kf_desc),
                kf_valid=np.asarray(self._kf_valid),
                kf_xyn=np.asarray(self._kf_xyn),
                kf_depth=np.asarray(self._kf_depth),
                edge_i=np.array([x[0] for x in e], np.int32),
                edge_j=np.array([x[1] for x in e], np.int32),
                edge_r=(np.stack([x[2] for x in e])
                        if e else np.zeros((0, 3, 3), np.float32)),
                edge_t=(np.stack([x[3] for x in e])
                        if e else np.zeros((0, 3), np.float32)),
                edge_s=np.array([x[4] for x in e], np.float32),
                edge_w=np.array([x[5] for x in e], np.float32),
            )
            if getattr(self, "_kf_pose_r", None) is not None:
                d["kf_pose_r"] = self._kf_pose_r
                d["kf_pose_t"] = self._kf_pose_t
            if getattr(self, "_corr", None) is not None:
                d["corr_r"], d["corr_t"], d["corr_s"] = self._corr
            if self._ref_feats is not None:
                d["ref_feats"] = np.concatenate(
                    [np.asarray(f, np.float32).reshape(
                        len(self._ref_feats.x), -1)
                     for f in self._ref_feats], axis=-1)
                d["ref_depth"] = np.asarray(self._ref_depth)
                d["ref_pose_r"], d["ref_pose_t"] = self._ref_pose
            if self.vo_cfg.map_anchor:
                d.update(
                    lmap_pos=np.asarray(self._lmap.pos),
                    lmap_desc=np.asarray(self._lmap.desc),
                    lmap_valid=np.asarray(self._lmap.valid),
                    lmap_seen=np.asarray(self._lmap.seen),
                    lmap_nobs=np.asarray(self._lmap.nobs),
                    dev_pose_r=np.asarray(self._dev_pose[0]),
                    dev_pose_t=np.asarray(self._dev_pose[1]),
                    dev_rel_r=np.asarray(self._dev_rel[0]),
                    dev_rel_t=np.asarray(self._dev_rel[1]),
                )
                if self._map_inl is not None:
                    d["map_inl"] = np.asarray(self._map_inl)
        np.savez_compressed(path, **d)

    @staticmethod
    def _unpack_feats(flat: np.ndarray) -> SiftFeatures:
        cols = np.split(flat, [1, 2, 3, 4, 5, 6, 7, 135], axis=-1)
        x, y, sig, ori, resp, edg, octv, desc, valid = cols
        return SiftFeatures(
            x=jnp.asarray(x[:, 0]), y=jnp.asarray(y[:, 0]),
            sigma=jnp.asarray(sig[:, 0]),
            orientation=jnp.asarray(ori[:, 0]),
            response=jnp.asarray(resp[:, 0]),
            edgeness=jnp.asarray(edg[:, 0]),
            octave=jnp.asarray(octv[:, 0].astype(np.int32)),
            desc=jnp.asarray(desc),
            valid=jnp.asarray(valid[:, 0] > 0.5))

    def restore(self, path: str):
        """Restore a `checkpoint` into this (identically-configured) VO."""
        z = np.load(path)
        self.poses_r = [r for r in z["poses_r"]]
        self.poses_t = [t for t in z["poses_t"]]
        self._scale = jnp.float32(z["scale"])
        self._last_rel = (z["last_rel_r"], z["last_rel_t"])
        self._ema_step = float(z["ema_step"])
        # key holds (seed, counter); pre-round-5 checkpoints stored a raw
        # split-chain key whose two words still seed a valid fresh stream
        self._seed = int(z["key"][0])
        self._key_ctr = int(z["key"][1])
        self._depth = jnp.asarray(z["depth"])
        self._feats = self._unpack_feats(z["feats"])
        self._ring = [(jnp.asarray(z[f"ring_desc_{k}"]),
                       jnp.asarray(z[f"ring_valid_{k}"]),
                       jnp.asarray(z[f"ring_pts_{k}"]))
                      for k in range(int(z["ring_n"]))]
        if self.vo_cfg is not None:
            self.n_kf = int(z["n_kf"])
            self.n_kf_total = int(z["n_kf_total"])
            self.n_closures = int(z["n_closures"])
            self._kf_frame = [int(v) for v in z["kf_frame"]]
            self._frame_ref = [int(v) for v in z["frame_ref"]]
            self._kf_desc = jnp.asarray(z["kf_desc"])
            self._kf_valid = jnp.asarray(z["kf_valid"])
            self._kf_xyn = jnp.asarray(z["kf_xyn"])
            self._kf_depth = jnp.asarray(z["kf_depth"])
            self._edges = [(int(i), int(j), r, t, float(s), float(w))
                           for i, j, r, t, s, w in zip(
                               z["edge_i"], z["edge_j"], z["edge_r"],
                               z["edge_t"], z["edge_s"], z["edge_w"])]
            if "kf_pose_r" in z:
                self._kf_pose_r = np.array(z["kf_pose_r"])
                self._kf_pose_t = np.array(z["kf_pose_t"])
            if "corr_r" in z:
                self._corr = (np.array(z["corr_r"]), np.array(z["corr_t"]),
                              np.array(z["corr_s"]))
            if "ref_feats" in z:
                self._ref_feats = self._unpack_feats(z["ref_feats"])
                self._ref_depth = jnp.asarray(z["ref_depth"])
                self._ref_pose = (np.array(z["ref_pose_r"]),
                                  np.array(z["ref_pose_t"]))
            if self.vo_cfg.map_anchor:
                assert "lmap_pos" in z, \
                    "checkpoint lacks map-anchor state (saved without it?)"
                from .monomap import LandmarkMap
                self._lmap = LandmarkMap(
                    pos=jnp.asarray(z["lmap_pos"]),
                    desc=jnp.asarray(z["lmap_desc"]),
                    valid=jnp.asarray(z["lmap_valid"]),
                    seen=jnp.asarray(z["lmap_seen"]),
                    nobs=jnp.asarray(z["lmap_nobs"]))
                self._dev_pose = (jnp.asarray(z["dev_pose_r"]),
                                  jnp.asarray(z["dev_pose_t"]))
                self._dev_rel = (jnp.asarray(z["dev_rel_r"]),
                                 jnp.asarray(z["dev_rel_t"]))
                self._map_inl = (jnp.asarray(z["map_inl"])
                                 if "map_inl" in z else None)

    def run(self, frames, max_frames: int | None = None) -> tuple:
        if self.pad_to_tier:
            # tier padding computes per-frame content metadata on the
            # host; keep the simple synchronous path
            for i, img in enumerate(frames):
                if max_frames is not None and i >= max_frames:
                    break
                self.process(img)
            return self.trajectory()
        from ..utils.pipeline import _prefetched

        def produce(emit):
            for img in frames:
                emit(jax.device_put(np.asarray(img, np.float32)))

        for i, dimg in enumerate(_prefetched(produce, prefetch=2)):
            if max_frames is not None and i >= max_frames:
                break
            self.process(dimg)
        return self.trajectory()
