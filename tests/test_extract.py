"""P2/P3 exit tests (SURVEY.md §7): keypoints + descriptors vs the cv2 oracle.

Order-invariant envelope comparison per SURVEY.md §4.2: greedy bipartite
match on (x, y, sigma), >= 70% mutual overlap on detectable scales,
descriptor cosine median >= 0.9.
"""

import numpy as np
import pytest

from cusift_tpu.config import SiftConfig
from cusift_tpu.models.sift import extract, extract_batch

from oracle import cosine, cv2_sift_oracle, greedy_keypoint_match

CFG = SiftConfig(max_kpts=1024, max_kpts_per_octave=512)


@pytest.fixture(scope="module")
def ours(test_image):
    f = extract(test_image, CFG)
    v = np.asarray(f.valid)
    return {
        "xy": np.stack([np.asarray(f.x)[v], np.asarray(f.y)[v]], -1),
        "sigma": np.asarray(f.sigma)[v],
        "angle": np.asarray(f.orientation)[v],
        "desc": np.asarray(f.desc)[v],
        "feats": f,
    }


@pytest.fixture(scope="module")
def oracle_out(test_image):
    xy, sig, ang, desc = cv2_sift_oracle(test_image)
    m = sig >= 1.9  # scales detectable without the 2x upscale octave
    return {"xy": xy[m], "sigma": sig[m], "angle": ang[m], "desc": desc[m]}


def test_keypoint_overlap(ours, oracle_out):
    pairs = greedy_keypoint_match(oracle_out["xy"], ours["xy"],
                                  oracle_out["sigma"], ours["sigma"])
    overlap = len(pairs) / max(len(oracle_out["xy"]), 1)
    assert overlap >= 0.70, f"keypoint overlap {overlap:.2f}"


@pytest.mark.slow
def test_unique_position_overlap_meets_survey_bar():
    """SURVEY §7 P2 exit bar (>= 85%), measured where it means detector
    agreement: UNIQUE keypoint positions under matched retention.  The
    slot-level number conflates orientation multiplicity (cv2 emits
    every >= 0.8-peak orientation as its own keypoint; we cap at 2) and
    the static budget (cv2 unbounded keeps every weak extremum) —
    measured decomposition in 62f0428:BASELINE.md round 4 (production
    budget: 0.884 unique vs 0.64 slot-level on the bench scene)."""
    from cusift_tpu.data.synthetic import textured_image

    img = textured_image(480, 640, seed=1, blobs=800, detail=0.25)
    cfg = SiftConfig(max_kpts=4096, max_kpts_per_octave=2048, upscale=True)
    f = extract(img, cfg)
    v = np.asarray(f.valid)
    xy = np.stack([np.asarray(f.x)[v], np.asarray(f.y)[v]], -1)
    sg = np.asarray(f.sigma)[v]
    oxy, osig, _, _ = cv2_sift_oracle(img, n_features=int(v.sum()))

    def uniq(pts, sig):
        key = np.round(np.concatenate(
            [pts / 0.5, np.log(np.maximum(sig, 1e-9))[:, None] / 0.05],
            axis=1)).astype(np.int64)
        _, idx = np.unique(key, axis=0, return_index=True)
        return pts[idx], sig[idx]

    uoxy, uosig = uniq(oxy, osig)
    uxy, usg = uniq(xy, sg)
    pairs = greedy_keypoint_match(uoxy, uxy, uosig, usg)
    overlap = len(pairs) / max(len(uoxy), 1)
    assert overlap >= 0.85, f"unique-position overlap {overlap:.3f}"


def test_orientation_agreement(ours, oracle_out):
    pairs = greedy_keypoint_match(oracle_out["xy"], ours["xy"],
                                  oracle_out["sigma"], ours["sigma"])
    i, j = np.array(pairs).T
    d = np.abs(((oracle_out["angle"][i] - ours["angle"][j] + np.pi)
                % (2 * np.pi)) - np.pi)
    assert np.median(d) < 0.1, f"median orientation delta {np.median(d):.3f} rad"


def test_descriptor_cosine(ours, oracle_out):
    pairs = greedy_keypoint_match(oracle_out["xy"], ours["xy"],
                                  oracle_out["sigma"], ours["sigma"])
    i, j = np.array(pairs).T
    cs = cosine(oracle_out["desc"][i], ours["desc"][j])
    assert np.median(cs) >= 0.9, f"median descriptor cosine {np.median(cs):.3f}"
    assert (cs > 0.8).mean() >= 0.7


def test_descriptors_unit_norm(ours):
    n = np.linalg.norm(ours["desc"], axis=-1)
    np.testing.assert_allclose(n, 1.0, atol=1e-4)


def test_invalid_slots_zeroed(ours):
    f = ours["feats"]
    v = np.asarray(f.valid)
    assert np.all(np.asarray(f.desc)[~v] == 0.0)


def test_batch_matches_single(test_image):
    cfg = SiftConfig(max_kpts=256, max_kpts_per_octave=128, num_octaves=3)
    single = extract(test_image, cfg)
    batched = extract_batch(np.stack([test_image, test_image]), cfg)
    np.testing.assert_allclose(np.asarray(batched.x[0]), np.asarray(single.x),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(batched.desc[1]),
                               np.asarray(single.desc), rtol=1e-4, atol=1e-5)


def test_octave_budget_override():
    """Explicit per-octave budgets override the decay scheme (bench knob)."""
    from cusift_tpu.config import SiftConfig

    cfg = SiftConfig(max_kpts_per_octave=2048,
                     octave_budgets=(2048, 1024, 256, 96, 32))
    assert [cfg.kpt_budget(o) for o in range(5)] == [2048, 1024, 256, 96, 32]
    # beyond the tuple, the last entry repeats; all results stay 8-aligned
    assert cfg.kpt_budget(7) == 32
    assert cfg.kpt_budget(2) % 8 == 0
    assert SiftConfig(max_kpts_per_octave=100).kpt_budget(0) == 104
    default = SiftConfig(max_kpts_per_octave=2048)
    assert [default.kpt_budget(o) for o in range(3)] == [2048, 1024, 512]
    # desc slots follow the budgets through desc_slot_factor (1.25 default)
    assert cfg.desc_slots(2) == 320


def test_bf16_score_parity(test_image):
    """score_dtype="bf16" only perturbs the weak tail of the candidate set.

    The extremum score ranks candidates into the static budget; bf16
    halves the dense stage's HBM bytes (config.py score_dtype).  Strong
    keypoints must be dtype-invariant: compare the top-half (by response)
    of the f32 extraction against the bf16 keypoint set.
    """
    cfg = SiftConfig(max_kpts=512, max_kpts_per_octave=256, num_octaves=3)
    f32 = extract(test_image, cfg)
    b16 = extract(test_image, SiftConfig(**{**cfg.__dict__,
                                            "score_dtype": "bf16"}))
    v32, v16 = np.asarray(f32.valid), np.asarray(b16.valid)
    # similar yield — loose: bf16 rounding ties the strict 26-neighbour
    # comparison on plateaus, which churns the weak tail (this fixture
    # only has ~56 keypoints, so tail churn is a large fraction; on the
    # 4-5k-keypoint bench scene the same churn is ~1-2%)
    assert abs(int(v16.sum()) - int(v32.sum())) <= 0.25 * max(int(v32.sum()), 1)
    resp = np.abs(np.asarray(f32.response))[v32]
    strong = resp >= np.median(resp)
    xy32 = np.stack([np.asarray(f32.x)[v32], np.asarray(f32.y)[v32]], -1)[strong]
    sg32 = np.asarray(f32.sigma)[v32][strong]
    xy16 = np.stack([np.asarray(b16.x)[v16], np.asarray(b16.y)[v16]], -1)
    sg16 = np.asarray(b16.sigma)[v16]
    # coverage, not bipartite matching: duplicate slots (plateau ties
    # refine to one point twice) would eat a greedy matcher's partners
    d = np.linalg.norm(xy32[:, None] - xy16[None], axis=-1)
    srel = np.abs(np.log(sg32[:, None] / np.maximum(sg16[None], 1e-9)))
    covered = np.any((d < 1.0) & (srel < 0.05), axis=1)
    assert covered.mean() >= 0.95, float(covered.mean())

