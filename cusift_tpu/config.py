"""Static configuration tree for the SIFT/SLAM engine.

The reference (danielsuo/cuSIFT, see SURVEY.md §5.6) has no config system —
compile-time ``#define``s and positional arguments (``thresh``, ``initBlur``,
``lowestScale``, ``numOctaves``).  Here every knob lives in a frozen (hashable)
dataclass so configs can be passed as static jit arguments: each distinct
config compiles exactly once and XLA sees fully static shapes.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


@dataclass(frozen=True)
class SiftConfig:
    """SIFT extraction parameters (reference: ExtractSift args + kernel #defines).

    Defaults follow Lowe 2004 / OpenCV so that `cv2.SIFT_create()` can serve
    as the behavioural oracle in tests (SURVEY.md §4).
    """

    # Scale space
    num_octaves: int = 5
    scales_per_octave: int = 3          # "S": DoG levels searched per octave
    sigma0: float = 1.6                 # base blur of octave level 0
    init_blur: float = 0.5              # assumed blur of the raw input image
    upscale: bool = False               # initial 2x upsample (octave -1)

    # Detection
    contrast_thresh: float = 0.04       # Lowe units (image in [0,1]); final cut is cT/S
    edge_thresh: float = 10.0           # Hessian ratio limit r: tr^2/det < (r+1)^2/r
    refine_iters: int = 0               # static refinement moves (+1 final solve).
                                        # 0 = single quadratic fit at the detected
                                        # location, exactly the reference's
                                        # FindPointsMulti behaviour; measured
                                        # identical cv2-parity (overlap 0.783,
                                        # desc cosine 0.9901 vs 0.9905), while
                                        # each extra move adds a full
                                        # 27-stencil gather + batched solve
    approx_topk: bool = True            # lax.approx_max_k for candidate
                                        # compaction (recall target 0.95;
                                        # exact on CPU and GPU)
    max_kpts_per_octave: int = 1024     # static candidate budget for octave 0
    # Octave o has 4^o fewer pixels, so a flat per-octave budget wastes most
    # of its gather/sample lanes on dead slots from octave 1 up.  The budget
    # halves per octave (floored at 32) when decay is enabled.
    octave_budget_decay: bool = True
    # Explicit per-octave candidate budgets (overrides the decay scheme when
    # set).  Every candidate slot costs refine+orientation+descriptor work
    # whether or not a real extremum fills it, so matching budgets to the
    # workload's per-octave extrema density is a first-order throughput
    # knob (bench.py uses this; see scripts/yield_probe.py).
    octave_budgets: tuple = ()
    max_kpts: int = 2048                # static global keypoint capacity (pre-orientation)
    border: int = 5                     # reject detections within this margin

    # Orientation assignment
    ori_bins: int = 36
    ori_sigma_factor: float = 1.5       # gaussian weight sigma = 1.5 * kp_sigma
    ori_radius_factor: float = 4.5      # sample window half-size = 4.5 * kp_sigma
    ori_grid: int = 12                  # fixed sample grid (ori_grid^2 samples / kpt)
    ori_peak_ratio: float = 0.8
    max_orientations: int = 2           # slots per keypoint (dominant + secondary)

    # Descriptor
    desc_width: int = 4                 # spatial cells per axis
    desc_bins: int = 8                  # orientation bins per cell
    desc_grid: int = 12                 # fixed sample grid (desc_grid^2 samples / kpt)
    desc_scale_factor: float = 3.0      # cell half-width = 3 * kp_sigma
    desc_clip: float = 0.2
    # descriptor slots per octave = max_kpts_per_octave * desc_slot_factor;
    # secondary orientations are rare (~10-25%), so sampling all
    # max_orientations slots wastes gather bandwidth on dead lanes.
    desc_slot_factor: float = 1.25

    # separable-convolution backend for the pyramid blurs: "vpu" (the
    # default: exact f32 shifted adds that XLA fuses into one loop), or
    # "mxu" / "mxu2" (banded matmuls, f32 at Precision.HIGHEST; "mxu2"
    # stacks windows in output layout).  ops/gaussian.py.
    conv_backend: str = "vpu"
    # octave level construction: "chain" (incremental blurs, the
    # reference LaplaceMulti structure) or "direct" (all levels from the
    # octave base in 2 batched einsums with cumulative-sigma taps)
    pyramid_impl: str = "chain"
    # extremum-score arithmetic dtype: "f32" or "bf16".  Scores only RANK
    # candidates into the static budget, so bf16's ~3 decimal digits
    # perturb the same weak tail that approx_topk's 0.95 recall already
    # does; refinement reads the f32 DoG regardless, and bf16 halves the
    # bytes of the dense window max/min stage.  The library default stays
    # f32: the cv2-oracle parity envelope and every accuracy test are
    # certified against f32 scoring, and throughput callers (bench.py,
    # chip_smoke.py) opt in.
    score_dtype: str = "f32"

    dtype: str = "float32"

    @property
    def levels_per_octave(self) -> int:
        # S blur levels searched + 3 extra (Lowe): S+3 gaussians, S+2 DoGs
        return self.scales_per_octave + 3

    @property
    def total_kpts(self) -> int:
        """Final per-frame (keypoint, orientation) descriptor-slot capacity.

        Equal to max_kpts: secondary orientations compete with weaker
        keypoints for the same static budget, which keeps the matcher's
        [N, N] program at the size the user asked for instead of 2x
        (4x the matmul) mostly-dead lanes.
        """
        return self.max_kpts

    def kpt_budget(self, octave: int) -> int:
        """Static candidate budget of one octave (multiple of 8)."""
        if self.octave_budgets:
            n = self.octave_budgets[min(octave, len(self.octave_budgets) - 1)]
        else:
            n = self.max_kpts_per_octave
            if self.octave_budget_decay:
                n = max(min(32, n), n >> octave)
        return max(8, (n + 7) // 8 * 8)

    def desc_slots(self, octave: int) -> int:
        """Compacted descriptor-slot capacity of one octave (multiple of 8)."""
        n = int(self.kpt_budget(octave) * self.desc_slot_factor)
        return max(8, (n + 7) // 8 * 8)

    @property
    def desc_slots_per_octave(self) -> int:
        """Octave-0 descriptor-slot capacity (kept for callers that size
        buffers for the worst octave)."""
        return self.desc_slots(0)

    def sigmas(self) -> tuple:
        """Absolute blur per level within an octave (relative to octave base)."""
        k = 2.0 ** (1.0 / self.scales_per_octave)
        return tuple(self.sigma0 * (k ** i) for i in range(self.levels_per_octave))

    def incremental_sigmas(self) -> tuple:
        """Blur to apply to level i-1 to reach level i (level 0 handled separately)."""
        sig = self.sigmas()
        out = []
        for i in range(1, self.levels_per_octave):
            out.append(math.sqrt(max(sig[i] ** 2 - sig[i - 1] ** 2, 1e-12)))
        return tuple(out)

    def num_octaves_for(self, h: int, w: int) -> int:
        """Octave count that keeps the smallest level >= ~16 px (cv2-like)."""
        base = min(h, w) * (2 if self.upscale else 1)
        if base < 16:
            return 1
        return min(self.num_octaves, int(math.log2(base / 8.0)))


@dataclass(frozen=True)
class MatchConfig:
    """Brute-force ratio-test matching (reference: MatchSiftData, SURVEY.md C12)."""

    ratio_thresh: float = 0.8           # Lowe ratio on L2 distances (d1/d2)
    min_score: float = -1.0             # optional floor on best correlation
    cross_check: bool = False
    # matcher backend: "auto" (the fused Pallas-Triton top-2 kernel on the
    # GPU for large pair batches, XLA otherwise), "triton", or "xla"
    # (ops/match.py:resolve_backend)
    backend: str = "auto"
    dtype: str = "float32"              # accumulate in f32; inputs may be bf16


@dataclass(frozen=True)
class RansacConfig:
    """Batched-hypothesis RANSAC (reference: FindHomography / rigid transform)."""

    num_hypotheses: int = 1024          # static hypothesis batch (thread-per-hyp analog)
    inlier_thresh: float = 3.0          # px reprojection error (homography)
    inlier_thresh_3d: float = 0.05      # metres (rigid RGB-D)
    # Sampson epipolar error in NORMALISED camera coords (pixels / focal);
    # 2e-3 ~ 1.4 px at KITTI's f~700 (essential-matrix RANSAC, monocular)
    inlier_thresh_epi: float = 2e-3
    # reprojection error in normalised coords for PnP (map-anchored
    # monocular localisation); 6e-3 ~ 4 px at f~700 — landmarks carry
    # triangulation noise, so the gate is looser than the epipolar one
    inlier_thresh_pnp: float = 6e-3
    # PnP hypotheses solve NON-minimal samples: low-parallax landmark
    # noise amplifies through a minimal 6-point DLT (measured: RANSAC
    # converges to garbage on the two-plane scene at sample size 6)
    pnp_sample_size: int = 12
    refine_iters: int = 5               # IRLS rounds on the winner's inliers
    min_matches: int = 8
    seed: int = 0


@dataclass(frozen=True)
class BAConfig:
    """Bundle adjustment: LM with matrix-free Schur complement + PCG."""

    max_iters: int = 20                 # outer LM iterations
    cg_iters: int = 50                  # PCG iterations on the camera system
    cg_tol: float = 1e-6
    init_damping: float = 1e-3
    damping_up: float = 4.0
    damping_down: float = 0.5
    huber_delta: float = 0.0            # 0 => plain L2 (inline Huber on
                                        # reprojection residuals, ba.py —
                                        # the graph kernels live on
                                        # PoseGraphConfig.robust_kernel)
    fix_first_pose: bool = True
    # reprojection BA has a 7-dof gauge (6 pose + 1 scale); fixing >= 2
    # poses pins it completely.  num_fixed_poses counts from pose 0 and
    # overrides fix_first_pose when > 0.
    num_fixed_poses: int = 1
    # Camera-system solver: "cg" (matrix-free Schur + PCG, the default —
    # also the only form the distributed landmark-sharded path supports,
    # forced there) or "dense" (explicitly assembled [6C, 6C] Schur
    # complement, U-whitened eigen-truncated solve).  "dense" was built
    # to kill the cg_iters sequential matvec latency in the fused
    # keyframe event and ships EXPERIMENTAL with a measured negative
    # result: the window system's condition reaches 1e8+, and every
    # exact-solve variant tried (Cholesky, LU+jitter, eigen truncation,
    # U-whitened truncation) measured worse end-to-end ATE than the
    # truncated-CG step, whose Krylov truncation is the regularisation
    # the window geometry needs (round-5 campaign: ATE 0.27-0.35 vs CG
    # 0.19 on the depth-noise drift scenario).  Keep "cg".
    solver: str = "cg"


@dataclass(frozen=True)
class PoseGraphConfig:
    max_iters: int = 20
    cg_iters: int = 100
    cg_tol: float = 1e-8
    init_damping: float = 1e-6
    fix_first_pose: bool = True
    # Huber scale on the per-edge UNWEIGHTED residual norm (IRLS
    # reweighting inside the LM loop; 0 = plain L2).  Edge weights express
    # confidence (sqrt-information) and are divided out before the kernel
    # so a weight-2 loop edge is not counter-penalised.  The graph residual blocks are
    # dimensionless (SE3 log / normalised translation / log scale), so one
    # scale serves both graphs: a healthy edge converges well under ~1
    # while a wrong-association loop edge sits at O(1) and, unrobustified,
    # hijacks the solve (measured: the 1000-frame mono soak's corrected
    # trajectory was WORSE than raw under plain L2).
    huber_delta: float = 0.0
    # kernel applied at huber_delta (optim/robust.py): "huber" (bounded
    # influence, linear tail), "cauchy" (decaying influence), "tukey"
    # (redescending — a gross outlier's influence goes to exactly zero;
    # needs the sane odometry-chain initialisation the frontends provide)
    robust_kernel: str = "huber"
    # normal-equation solver: "cg" (matrix-free Gauss-Newton — the only
    # form the trajectory-partitioned distributed path supports, where it
    # is forced) or "dense" (per-edge Jacobian assembly + Cholesky —
    # replaces max_iters*cg_iters sequential matvecs with a few batched
    # ops per LM iteration at the streaming loop's 48-node graphs; its
    # time on the GPU is not measured yet).  The SLAM/VO drivers pass
    # "dense"; default stays "cg" so existing solver behaviour (and the
    # dist-vs-single parity tests) are unchanged.
    solver: str = "cg"


@dataclass(frozen=True)
class SlamConfig:
    """Keyframe RGB-D SLAM frontend/backend (new surface; BASELINE configs[3])."""

    max_keyframes: int = 256
    kf_min_inliers: int = 60            # fewer inliers than this => new keyframe
    kf_max_translation: float = 0.25    # metres
    kf_max_rotation: float = 0.25       # radians
    track_min_inliers: int = 12         # below this tracking is declared lost
    loop_min_score: float = 0.10        # global-descriptor similarity gate
    loop_temporal_gap: int = 20         # keyframes; ignore recent neighbours
    loop_min_inliers: int = 40          # geometric verification gate
    checkpoint_every: int = 0           # keyframes between checkpoints (0 = off)
    # sliding-window local BA (BASELINE north star "extract+match+BA"):
    # bundle-adjust the last `local_ba_window` keyframes on every insert
    # once the window is full; 0 disables.  The two oldest window poses
    # are the gauge anchors (pins the 7-dof similarity gauge).
    local_ba_window: int = 5
    local_ba_iters: int = 5             # LM iterations per insert
    local_ba_cg_iters: int = 15         # PCG iterations on the camera system
    # landmark anchoring scheme (models/local_ba.py): "newest" anchors
    # landmarks to the newest keyframe only (cheapest; VERDICT round-2
    # weak #4); "union" deduplicates landmark candidates across the whole
    # window through the match graph.  "union" forces the single-device
    # BA path: the streaming distributed solver's static landmark-block
    # sharding requires the newest-anchored [W, N] grid layout (landmark
    # n owns column n), which the union's owner indirection breaks.
    local_ba_anchor: str = "newest"
    # keyframe eviction once the ring is full (sequence-scale realism:
    # KITTI/TUM-length runs need far more keyframes than any static ring
    # holds, and closures fire on INSERT — a full ring silently turns
    # loop closure off).  "redundant" thins the densest stretch of camera
    # centres (keeps spatial coverage so revisits still retrieve),
    # "oldest" is FIFO (sliding-window odometry semantics), "none"
    # restores the round-2 stop-growing behaviour.  Either eviction
    # shifts the ring left so slot index stays temporal order, which the
    # local-BA window and the loop temporal gap assume; frames referenced
    # to an evicted keyframe are baked to absolute poses frozen at its
    # final estimate (marginalisation semantics — they stop receiving
    # retroactive loop corrections).
    kf_evict: str = "redundant"
    # fuse the per-keyframe-insert backend (window BA + loop-closure
    # retrieval/verification + conditional dense pose-graph solve) into
    # ONE device program with one packed upload and one packed fetch
    # (models/slam.py:_kf_event_step), instead of three programs with
    # their own uploads and fetches.  Automatically falls back to the
    # split form for "union" BA anchoring or distributed BA (their
    # solvers need layouts the fused program does not carry).
    fused_events: bool = True
    # apply the fused event's packed result LAZILY: _kf_event dispatches
    # the device program and returns immediately; the fetch happens at
    # the next reader of the pose/edge state (the next keyframe insert,
    # trajectory(), checkpoint()).  The event program then overlaps the
    # following frames' host work instead of blocking the loop.
    # Results are bit-identical to the eager form: every state reader
    # drains first, and the PRNG key is consumed at dispatch either way.
    # The per-frame metric record's "loop" field is patched at drain
    # (one event late through any streaming on_metric callback).
    defer_events: bool = True


@dataclass(frozen=True)
class VOConfig:
    """Sequence-scale monocular VO (KITTI frontend, BASELINE configs[4]).

    Adds the keyframe ring + loop closure + pose graph that bound drift on
    long sequences; mirrors SlamConfig for the RGB-D backend.  The pose
    graph is Sim(3) (optim/sim3graph.py): monocular scale drift along the
    chain is an explicit per-node degree of freedom, and loop edges carry
    the measured relative epoch scale (models/odometry.py
    `_loop_verify_step`) — an SE(3) graph physically cannot absorb the
    inconsistency (tests/test_sim3.py has the constructed failure).
    """

    max_keyframes: int = 128
    kf_every: int = 5               # frames between keyframes (upper bound)
    kf_min_rotation: float = 0.15   # radians since last keyframe
    # translation promotion gate in MULTIPLES of the smoothed per-pair
    # translation (monocular global units are arbitrary, so an absolute
    # threshold would promote every frame or never depending on where the
    # first pair anchored the scale)
    kf_min_translation: float = 4.0
    loop_min_score: float = 0.10    # retrieval similarity gate
    loop_temporal_gap: int = 20     # keyframes; ignore recent neighbours
    loop_min_inliers: int = 60      # essential-inlier verification gate
    loop_min_common: int = 8        # tracked-depth overlap for edge scale
    # keyframe eviction once the ring is full, mirroring
    # SlamConfig.kf_evict: KITTI-length sequences need far more keyframes
    # than any static ring, and loop closures fire on INSERT.  Cheaper
    # here than in RGB-D SLAM: mono frames re-derive their relative pose
    # from the raw chain at output time, so frames riding an evicted
    # keyframe just inherit the previous keyframe's correction (no pose
    # baking); Sim(3) odometry edges through the victim compose exactly.
    kf_evict: str = "redundant"     # "redundant" | "oldest" | "none"
    # tracking reference: "prev" chains every consecutive pair (the
    # round-2/3 baseline), "keyframe" tracks each frame against the last
    # KEYFRAME — per-pair baseline grows ~kf_every-fold (attacking the
    # sub-SNR parallax regime that binds the synthetic soaks) and the
    # multiplicative scale chain steps once per KEYFRAME instead of once
    # per frame.  "keyframe" is mutually exclusive with map_anchor (the
    # map localiser's device pose state assumes prev-frame relatives).
    # Measured win regime (round 4, the forward/KITTI-like motion it was
    # designed for — persistent structure, strong per-frame parallax):
    # t_pct 20.5 vs the chain's 29.5, ATE 2.53% vs 3.25% of path
    # (62f0428:BASELINE.md forward-regime table); on lateral loop scenes it is
    # ~parity, so "prev" stays the default for generic rigs.
    track_ref: str = "prev"
    # persistent-map scale anchoring (models/monomap.py): localise every
    # frame against a landmark map with PnP RANSAC instead of trusting the
    # per-pair depth-ratio scale chain (whose coherent error random-walks
    # multiplicatively — 62f0428:BASELINE.md round-3 drift campaign).
    # EXPERIMENTAL — FROZEN (round-4 decision): measured parity-to-worse
    # on every synthetic regime INCLUDING the forward/persistent-structure
    # one it was designed for (t_pct 32.5 vs the chain's 29.5; the anchor
    # observable s_med/scale pins at ~1.0 — it measures the chain against
    # itself).  Kept for real-data evaluation only; not grown further.
    map_anchor: bool = False
    map_size: int = 8192            # landmark table capacity
    map_active_kf: int = 6          # match only landmarks seen this recently
    map_insert_budget: int = 512    # new landmarks per keyframe
    map_min_inliers: int = 20       # PnP acceptance gate
    # observations a landmark must fold into its running mean before it
    # FREEZES and may anchor the scale: a fresh landmark replays its
    # creation pair's coherent error (anchoring on it is the chain in
    # disguise), and continued refinement after maturity makes the map
    # follow the drift it should resist (62f0428:BASELINE.md round-3 map-anchor
    # campaign)
    map_min_obs: int = 8
    map_min_anchor: int = 16        # mature landmarks needed per accept
    # per-frame exponent on the measured map/chain scale ratio: the map
    # anchors the LOW-frequency scale (drift correction with a ~1/gain
    # frame time constant) while the chain keeps per-frame smoothness —
    # gain 1.0 injects the anchor measurement's full per-frame noise
    # (measured ±15% on the two-plane scene), gain 0 disables anchoring
    map_scale_gain: float = 0.4
    # essential-failure recovery (VERDICT r4 task 3): when the per-pair
    # essential RANSAC fails (low-parallax/sub-SNR frames fail the
    # cheirality majority), re-measure the pose with PnP RANSAC against
    # the reference frame's chain-scaled triangulated depths instead of
    # surrendering to constant-velocity carry — the pose comes out at
    # the chain's global scale directly (no new scale step), and the
    # depth chain transfers through the rescued pose so the NEXT pair
    # still has anchors.  Compiled behind lax.cond: healthy frames pay
    # nothing.
    pnp_rescue: bool = True
    # Sim(3) correction health gate (VERDICT r3 task 3): the 1000-frame
    # soak measured the corrected trajectory WORSE than raw (t_pct 82.5 vs
    # 51.5) because a late-run scale-chain collapse poisons the loop
    # edges' med_b/med_a scale observables COHERENTLY — robust kernels
    # cannot see it (the poisoned edges agree with each other).  The gate
    # validates each solve against the smooth-motion prior the frontend
    # already trusts (the scale clamp): per-keyframe-segment camera speed
    # should not get LESS uniform under a genuine drift correction.
    # "speed" rejects a solve whose log-speed dispersion exceeds
    # raw's by sim3_gate_margin (keeping the last accepted correction);
    # "off" applies every solve (the round-3 behaviour).
    sim3_gate: str = "speed"
    # multiplicative headroom on the corrected/raw log-speed dispersion
    # ratio; measured: healthy 300-frame solves sit at <= ~1.0x raw while
    # the poisoned 1000-frame solves blow past it (scripts/gate_probe.py)
    sim3_gate_margin: float = 1.15
    # Second (motion-free) acceptance route, fixing the absolute gate's
    # false-reject direction (VERDICT r4 weak #2): when ground-truth
    # speed is genuinely non-uniform (stop-and-go) and the raw chain's
    # drift happens to SMOOTH the speed profile, a correct solve
    # legitimately raises dispersion and the speed gate alone rejects
    # it.  The correction's own per-segment speed modification
    # log(v_corr/v_raw) is motion-free (true motion cancels in the
    # ratio): genuine drift corrections apply SMOOTH modifications
    # (slow multiplicative random walks), while poisoned chain-collapse
    # corrections jump by e^2 within a couple of keyframes.  A solve is
    # accepted when EITHER the speed gate passes OR the modification
    # roughness std(diff(log(v_corr/v_raw))) stays under this ceiling.
    sim3_gate_smooth: float = 0.10


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout (SURVEY.md §2.4 D1): frames = DP analog, map = TP analog."""

    frames_axis: int = 0                # 0 => use all devices on "frames"
    map_axis: int = 1
    axis_names: tuple = ("frames", "map")


def replace(cfg, **kw):
    """Functional config update (frozen dataclasses)."""
    return dataclasses.replace(cfg, **kw)
