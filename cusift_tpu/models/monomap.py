"""Persistent-landmark map tracking for monocular VO (scale anchoring).

The round-3 drift campaign (62f0428:BASELINE.md) measured the per-pair depth-ratio
scale chain as the binding error source of the KITTI frontend: its error is
COHERENT per pair (shared motion-estimate error) and random-walks
multiplicatively through the chain — no per-point aggregation, per-slot
depth filtering, gating, or clamping removed it.  The structural fix is to
stop chaining: maintain a persistent map of 3D landmarks at global scale
and localise every frame against it with PnP RANSAC (`ops/pnp.py`).  A
landmark's scale error is set once at its creation epoch and averaged over
landmarks from MANY epochs at every localisation, so the drift correlation
length becomes the landmark lifetime (tens of frames), not one pair.

Scope discipline (mirrors the raw-chain philosophy of models/odometry.py):

* The map lives in the RAW odometry frame.  Loop closures correct
  trajectories through the Sim(3) layer at output time; map landmarks are
  never rewritten by a closure.
* Matching is restricted to RECENTLY-seen landmarks (`map_active_kf`
  keyframe window): PnP does local tracking, re-detection of old map
  regions is the loop-closure layer's job — letting PnP snap to a
  drifted-away old epoch would fight the Sim(3) graph's smooth-raw-chain
  assumption.

Design: fixed-capacity landmark table (positions, descriptors,
validity, last-seen epoch), one jitted localisation program per frame
(match + PnP + on-device pose selection + depth re-scaling + seen-epoch
scatter), one jitted insertion program per keyframe (top-k eviction of
invalid/oldest slots, top-k response-ranked candidates).  All shapes
static.  The pose/last-relative state lives ON DEVICE and is updated
inside the jitted step — uploading the previous pose from the host every
frame would add an upload per frame; the host reads its copy from the
frame's single packed fetch.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import MatchConfig, RansacConfig
from ..ops.geometry import masked_median
from ..ops.match import match
from ..ops.pnp import find_pnp


class LandmarkMap(NamedTuple):
    """Fixed-capacity landmark table (device arrays)."""

    pos: jnp.ndarray    # [M, 3] world-frame positions (raw-chain frame)
    desc: jnp.ndarray   # [M, 128] descriptor at creation
    valid: jnp.ndarray  # [M] bool
    seen: jnp.ndarray   # [M] int32 keyframe epoch last observed (-1 = never)
    nobs: jnp.ndarray   # [M] int32 observations folded into `pos`


class MapTrack(NamedTuple):
    """Device-side outputs of one map-tracking frame step."""

    packed: jnp.ndarray   # [17] host fetch: r(9), t(3), scale, n_pnp,
                          #      ok_pnp, s_med, n_anchor
    pose_r: jnp.ndarray   # [3, 3] selected world-to-camera pose
    pose_t: jnp.ndarray   # [3]
    rel_r: jnp.ndarray    # [3, 3] selected relative motion (next fallback)
    rel_t: jnp.ndarray    # [3]
    scale: jnp.ndarray    # scalar: running per-pair |t| scale state
    depth: jnp.ndarray    # [N] per-slot depth, map-anchored units
    pts: jnp.ndarray      # [N, 3] camera-frame points, map-anchored units
    inliers: jnp.ndarray  # [N] bool: slots that localised against the map
    lmap: LandmarkMap     # updated map (refined positions, seen, nobs)


def empty_map(size: int) -> LandmarkMap:
    return LandmarkMap(pos=jnp.zeros((size, 3), jnp.float32),
                       desc=jnp.zeros((size, 128), jnp.float32),
                       valid=jnp.zeros(size, bool),
                       seen=jnp.full(size, -1, jnp.int32),
                       nobs=jnp.zeros(size, jnp.int32))


def _xyn(x, y, intr):
    return jnp.stack([(x - intr[2]) / intr[0], (y - intr[3]) / intr[1]], -1)


@partial(jax.jit, static_argnames=("match_cfg", "ransac_cfg"))
def localize_step(desc, valid, x, y, intr, depth_chain, pts_chain,
                  pair_ok, pair_r_rel, pair_t_rel, chain_scale, prev_scale,
                  prev_r, prev_t, last_rel_r, last_rel_t,
                  lmap: LandmarkMap, kf_epoch, active_lo, min_inliers,
                  min_obs, min_anchor, scale_gain,
                  match_cfg: MatchConfig, ransac_cfg: RansacConfig,
                  key) -> MapTrack:
    """Finish one map-anchored frame: match + PnP + on-device pose select.

    Consumes the frame's `pair_step` outputs (chain-scaled depths/points,
    relative motion, chain scale) plus the device pose state, and selects
    between the PnP pose (map scale, preferred) and the chain/constant-
    velocity fallback entirely on device.  On PnP accept, this frame's
    triangulated depths/points are re-scaled from chain units into map
    units so the depth chain (loop-closure scale observables, the BA ring)
    rides the anchored scale.  Depths triangulated from a REJECTED
    essential model stay zeroed regardless (garbage geometry must not
    enter the chain — same rule the host applies in chain mode).
    """
    xyn = _xyn(x, y, intr)
    active = lmap.valid & (lmap.seen >= active_lo)
    m = match(desc, valid, lmap.desc, active, match_cfg)
    pts_lm = lmap.pos[m.idx]
    ok_m = m.ok & valid

    # chain candidate pose (constant-velocity fallback on pair failure);
    # it seeds the PnP hypothesis pool as the LO-RANSAC motion prior
    r_rel_c = jnp.where(pair_ok, pair_r_rel, last_rel_r)
    t_rel_c = jnp.where(pair_ok, pair_t_rel, last_rel_t)
    r_chain = r_rel_c @ prev_r
    t_chain = r_rel_c @ prev_t + t_rel_c
    res = find_pnp(pts_lm, xyn, ok_m, ransac_cfg, key,
                   init=(r_chain, t_chain))

    # Map-anchored SCALE, not map-anchored translation — and the scale
    # observable must be POSE-FREE.  Two measured dead ends (300-frame
    # soak campaign) motivate the shape of this estimator:
    # * PnP translation is weakly observable at this depth/baseline
    #   ratio (z/b ~ 30-100): adopting |t_pnp| as the scale injects a
    #   40% error per accept and cascades through the depth chain.
    # * landmark depths UNDER A POSE are no better: the along-ray pose
    #   component is exactly PnP's weak direction, and with the chain
    #   candidate seeding the hypothesis pool the solution settles near
    #   the chain pose — z_map/za then measures the chain against
    #   itself (s_med/scale pinned at ~1.00, anchor corrects nothing).
    # The similarity-transform scale needs no pose at all: the matched
    # landmark cloud (map units, world frame) and this frame's fresh
    # |t|=1 triangulation (unit-baseline camera frame) differ by one
    # rotation + translation + SCALE, so the ratio of INTER-POINT
    # distances is a direct scale measurement — rotation and
    # translation cancel, the pair's coherent |t| error scales the
    # whole fresh cloud and is exactly the signal.  Median over rolled
    # pairings at several strides.  Gates: only MATURE landmarks
    # (>= min_obs folded observations — a fresh landmark replays its
    # creation pair's coherent error), the low-parallax cut of
    # pair_step (za > 500 is noise-dominated), and a minimum fresh
    # separation (near-coincident points make the ratio noise/noise).
    za_unit = depth_chain / jnp.maximum(chain_scale, 1e-12)
    p_unit = pts_chain / jnp.maximum(chain_scale, 1e-12)
    mature = lmap.nobs[m.idx] >= min_obs
    good = (res.inliers & ok_m & mature
            & (za_unit > 1e-6) & (za_unit < 500.0))
    ratios, masks = [], []
    for shift in (1, 3, 7):
        d_map = jnp.linalg.norm(pts_lm - jnp.roll(pts_lm, shift, 0), axis=-1)
        d_unit = jnp.linalg.norm(p_unit - jnp.roll(p_unit, shift, 0),
                                 axis=-1)
        ratios.append(d_map / jnp.maximum(d_unit, 1e-9))
        masks.append(good & jnp.roll(good, shift, 0) & (d_unit > 1.0))
    n_anchor = jnp.sum(good.astype(jnp.int32))
    s_med = masked_median(jnp.concatenate(ratios),
                          jnp.concatenate(masks))
    pnp_geom = res.ok & (res.num_inliers >= min_inliers)
    ok = (pnp_geom & pair_ok & (n_anchor >= min_anchor)
          & jnp.isfinite(s_med) & (s_med > 1e-9)
          & (s_med < 2.0 * prev_scale) & (s_med > prev_scale / 2.0))
    # damp the anchor: correct the chain scale TOWARD the map measurement
    # at rate `scale_gain` per frame instead of adopting its per-frame
    # noise outright (the map bounds drift; the chain keeps smoothness)
    s_anch = chain_scale * (s_med / jnp.maximum(chain_scale, 1e-12)) \
        ** scale_gain
    t_dir = pair_t_rel / jnp.maximum(jnp.linalg.norm(pair_t_rel), 1e-12)
    rel_t_a = t_dir * s_anch

    # pure-PnP rescue: the pair failed (e.g. near-pure rotation, an
    # essential degeneracy) but the map still localises — take the full
    # PnP pose rather than the constant-velocity guess
    r_rel_p = res.r @ prev_r.T
    t_rel_p = res.t - r_rel_p @ prev_t
    s_pnp = jnp.linalg.norm(t_rel_p)
    rescue = (pnp_geom & ~pair_ok & jnp.isfinite(s_pnp)
              & (s_pnp < 2.0 * prev_scale))

    rel_r = jnp.where(rescue, r_rel_p, r_rel_c)
    rel_t = jnp.where(ok, rel_t_a, jnp.where(rescue, t_rel_p, t_rel_c))
    r_new = rel_r @ prev_r
    t_new = rel_r @ prev_t + rel_t
    # running scale state: anchored scale > chain estimate > held value
    s_new = jnp.where(ok, s_anch,
                      jnp.where(rescue, s_pnp,
                                jnp.where(pair_ok, chain_scale,
                                          prev_scale)))
    ratio = jnp.where(ok, s_anch / jnp.maximum(chain_scale, 1e-12), 1.0)
    keep = pair_ok  # garbage-depth rule (models/odometry.py)
    depth = jnp.where(keep, depth_chain * ratio, 0.0)
    pts_b = jnp.where(keep, pts_chain * ratio, 0.0)
    ok = ok | rescue

    # bookkeeping keys on the GEOMETRIC inlier set (PnP localised the
    # frame), not the scale accept: gating refinement on the accept would
    # be circular — landmarks mature through refinement, and the accept
    # requires mature landmarks
    inl = res.inliers & ok_m & pnp_geom
    seen = lmap.seen.at[m.idx].max(
        jnp.where(inl, kf_epoch, jnp.int32(-1)), mode="drop")
    # landmark refinement: fold this frame's triangulation of each inlier
    # landmark into a running mean of world positions.  The per-pair
    # triangulation error is COHERENT within a pair but INDEPENDENT across
    # pairs (62f0428:BASELINE.md round-3 drift campaign), so the mean over a
    # landmark's lifetime converges ~1/sqrt(n_obs) — this is the mechanism
    # that makes the map a better scale anchor than any single chain
    # epoch.  A one-shot map would merely replay its creation pair's
    # coherent error (measured: PnP against unrefined landmarks cascades
    # — one weak-translation accept corrupts the chain, the next keyframe
    # inserts corrupted landmarks, tracking diverges).  Refinement STOPS
    # at maturity (nobs >= min_obs): any continued averaging — even at
    # uncapped 1/(n+1) weights — keeps ingesting observations at the
    # CURRENT accepted scale, so the anchor set itself slowly follows
    # the very drift it is supposed to resist (measured: with capped
    # weights the map tracked the chain at a ~17-frame time constant and
    # s_med/scale pinned at 1.00; uncapped weights only stretched the
    # time constant).  Frozen-at-maturity landmarks make the scale
    # lineage generational: young landmarks average their creation
    # noise, freeze, anchor the next generation.
    upd = inl & (depth > 1e-6) & (lmap.nobs[m.idx] < min_obs)
    pts_cam = jnp.concatenate([xyn, jnp.ones_like(xyn[:, :1])], -1) \
        * depth[:, None]
    fresh_w = (pts_cam - t_new) @ r_new            # rows: R^T (x - t)
    # The match is a per-query argmax (no cross check), so SEVERAL frame
    # features can best-match the same landmark.  Their triangulations
    # share this pair's coherent error, so the frame contributes ONE
    # observation per landmark: segment-mean the duplicates first, then
    # fold the mean at 1/(n+1).  Naive per-row scatter-add would both
    # wipe the prior mean (k rows each add (f_i - old)/(n+1) computed
    # from the SAME stale position) and inflate nobs by k, maturing —
    # and freezing — the landmark on fewer independent pairs than
    # `min_obs` demands.
    cnt = jnp.zeros(lmap.pos.shape[0], jnp.float32).at[m.idx].add(
        upd.astype(jnp.float32), mode="drop")
    sum_f = jnp.zeros_like(lmap.pos).at[m.idx].add(
        jnp.where(upd[:, None], fresh_w, 0.0), mode="drop")
    has = cnt > 0.0
    mean_f = sum_f / jnp.maximum(cnt, 1.0)[:, None]
    w_obs = 1.0 / (lmap.nobs.astype(jnp.float32) + 1.0)
    pos = jnp.where(has[:, None],
                    lmap.pos + (mean_f - lmap.pos) * w_obs[:, None],
                    lmap.pos)
    nobs = lmap.nobs + has.astype(jnp.int32)
    lmap2 = LandmarkMap(pos=pos, desc=lmap.desc, valid=lmap.valid,
                        seen=seen, nobs=nobs)
    packed = jnp.concatenate([
        r_new.reshape(-1), t_new,
        jnp.stack([s_new, res.num_inliers.astype(jnp.float32),
                   ok.astype(jnp.float32), s_med,
                   n_anchor.astype(jnp.float32)])])
    return MapTrack(packed=packed, pose_r=r_new, pose_t=t_new,
                    rel_r=rel_r, rel_t=rel_t, scale=s_new,
                    depth=depth, pts=pts_b, inliers=inl, lmap=lmap2)


@partial(jax.jit, static_argnames=("budget",))
def insert_step(lmap: LandmarkMap, desc, valid, response, x, y, intr, depth,
                already_inlier, pose_r, pose_t, kf_epoch,
                budget: int) -> LandmarkMap:
    """Insert up to `budget` new landmarks from the current keyframe.

    Candidates: valid feature slots with a (map-scale) triangulated depth
    that did NOT just localise against an existing landmark, ranked by DoG
    response.  Slots: invalid first, then oldest-seen (static top-k
    eviction — the map is a recency ring, staleness is already excluded
    from matching by `map_active_kf`).
    """
    budget = min(budget, valid.shape[0], lmap.valid.shape[0])
    xyn = _xyn(x, y, intr)
    good = valid & (depth > 1e-6) & ~already_inlier
    pts_cam = jnp.concatenate([xyn, jnp.ones_like(xyn[:, :1])], -1) \
        * depth[:, None]
    pts_w = (pts_cam - pose_t) @ pose_r            # rows: R^T (x - t)

    cand_key = jnp.where(good, response, -jnp.inf)
    _, cand_idx = jax.lax.top_k(cand_key, budget)
    cand_good = good[cand_idx]

    evict_key = jnp.where(lmap.valid, -lmap.seen.astype(jnp.float32),
                          jnp.inf)
    _, slot_idx = jax.lax.top_k(evict_key, budget)

    sel = cand_good[:, None]
    pos = lmap.pos.at[slot_idx].set(
        jnp.where(sel, pts_w[cand_idx], lmap.pos[slot_idx]))
    dsc = lmap.desc.at[slot_idx].set(
        jnp.where(sel, desc[cand_idx], lmap.desc[slot_idx]))
    vld = lmap.valid.at[slot_idx].set(
        jnp.where(cand_good, True, lmap.valid[slot_idx]))
    seen = lmap.seen.at[slot_idx].set(
        jnp.where(cand_good, kf_epoch, lmap.seen[slot_idx]))
    nobs = lmap.nobs.at[slot_idx].set(
        jnp.where(cand_good, 1, lmap.nobs[slot_idx]))
    return LandmarkMap(pos=pos, desc=dsc, valid=vld, seen=seen, nobs=nobs)
