"""Typed configuration for the PyTorch port.

A copy of lidar_slam_tpu/config.py (importing that module would run
lidar_slam_tpu/__init__.py and pull in JAX). The dataclasses, field names
and defaults are identical; tests/test_torch_port_imports.py holds every
dataclass equal to the JAX package's with dataclasses.asdict.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RobotConfig:
    """Differential-drive platform constants (reference: modules/localization.py:9-13,
    docs/RobotConfiguration.pdf)."""

    wheel_diameter: float = 0.254
    ticks_per_rev: int = 360
    dist_per_tick: float = 0.0022  # meters per encoder tick
    encoder_freq: float = 40.0  # Hz

    @property
    def dt(self) -> float:
        return 1.0 / self.encoder_freq


@dataclasses.dataclass(frozen=True)
class LidarConfig:
    """Hokuyo scan geometry (reference: modules/localization.py:273-278,297-298)."""

    n_rays: int = 1081
    angle_min_deg: float = -135.0
    angle_max_deg: float = 135.0
    # Lidar -> robot extrinsic: translation only, R = I
    # (reference: modules/localization.py:297-302, duplicated modules/ogm.py:165).
    p_rl: Tuple[float, float, float] = (0.13323, 0.0, 0.51435)

    @property
    def angle_min(self) -> float:
        return math.radians(self.angle_min_deg)

    @property
    def angle_max(self) -> float:
        return math.radians(self.angle_max_deg)


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Occupancy grid geometry (reference: modules/ogm.py:7-43, main.py:27-29,198-202)."""

    resolution: float = 0.05
    world_max_x: float = 30.0
    world_max_y: float = 30.0
    world_min_x: float = -30.0
    world_min_y: float = -30.0
    buffer: float = 1.0
    logodds_clip: float = 20.0  # reference: modules/ogm.py:188

    @property
    def logodds_ratio(self) -> float:
        # reference: modules/ogm.py:43
        return math.log(4.0)

    @property
    def width(self) -> int:
        # reference: modules/ogm.py:37
        return int(math.ceil((self.world_max_x - self.world_min_x) / self.resolution + self.buffer))

    @property
    def height(self) -> int:
        # reference: modules/ogm.py:38
        return int(math.ceil((self.world_max_y - self.world_min_y) / self.resolution + self.buffer))

    @staticmethod
    def from_cli(res: float, width: float, height: float) -> "MapConfig":
        # reference: main.py:198-202 (width/height flags are full extents, centered)
        return MapConfig(
            resolution=res,
            world_max_x=width / 2.0,
            world_min_x=-width / 2.0,
            world_max_y=height / 2.0,
            world_min_y=-height / 2.0,
        )


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Kinect intrinsics / extrinsics / disparity model
    (reference: main.py:217-232, modules/texture_mapping.py:144-163,213-217)."""

    # Intrinsics K (reference: main.py:228-232)
    fx: float = 585.05
    fy: float = 585.05
    cx: float = 242.94
    cy: float = 315.84
    # Camera -> robot extrinsic: 18 degree pitch (reference: main.py:217-225)
    pitch_deg: float = 18.0
    p_rc: Tuple[float, float, float] = (0.16766, 0.0, 0.38001)
    # Disparity -> depth model (reference: modules/texture_mapping.py:144-145)
    disp_a: float = -0.00304
    disp_b: float = 3.31
    depth_scale: float = 1.03
    # RGB registration (reference: modules/texture_mapping.py:161-162)
    reg_scale: float = 526.37
    reg_i_off: float = 19276.0
    reg_dd: float = 7877.07
    reg_j_off: float = 16662.0
    reg_div: float = 585.051


@dataclasses.dataclass(frozen=True)
class IcpConfig:
    """ICP stopping rules (reference: modules/icp.py:123-133, localization.py:120-123)."""

    epsilon: float = 0.001
    max_iters: int = 2000
    stopping_thresh: float = 1e-4
    normalize_error: bool = False
    # Correspondence metric for scan matching: "point" (reference parity,
    # modules/icp.py:100-121) or "point_to_line" (PLICP — fit + error
    # against the matched target points' local surface lines, removing
    # the half-ray-spacing bias of nearest-SAMPLE correspondence and
    # converging in far fewer iterations; ops/icp.py, ops/kabsch.py).
    metric: str = "point"


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    """Pose-graph factor noise + loop-closure schedule (reference: main.py:148-172)."""

    prior_sigmas: Tuple[float, float, float] = (0.1, 0.1, 0.1)
    between_sigmas: Tuple[float, float, float] = (0.3, 0.3, 0.3)
    loop_sigmas: Tuple[float, float, float] = (0.3, 0.3, 0.3)
    fixed_interval: int = 10  # reference: main.py:20,158
    # Levenberg-Marquardt schedule (replacement for gtsam.LevenbergMarquardtOptimizer,
    # reference: main.py:181-182)
    max_lm_iters: int = 50
    lambda_init: float = 1e-4
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    cg_iters: int = 250
    cg_tol: float = 1e-8
    # stop after 3 LM iterations with relative cost decrease below this.
    # 1e-5 matches gtsam.LevenbergMarquardtParams relativeErrorTol — the
    # reference's own stopping rule (and GTSAM ALSO stops on absolute
    # decrease < 1e-5, far looser than this on whitened graphs). Measured
    # on the bench problem: the 1e-7 tail spent ~14 extra iterations
    # polishing f32 noise (rel drops 1e-6..1e-7, poses essentially
    # unchanged). Tests that pin deeper convergence pass cost_rtol
    # explicitly (optimize()'s own default stays 1e-9).
    cost_rtol: float = 1e-5
    # Robust m-estimator on LOOP factors: "none" (reference parity — the
    # reference relies on hard distance/yaw gates alone, main.py:163-172),
    # "huber", or "cauchy" (gtsam.noiseModel.mEstimator analogs, applied
    # IRLS-style inside LM). delta is the kernel width in whitened units.
    robust_loss: str = "none"
    robust_delta: float = 1.0
    # "direct": exact block-tridiagonal LDL^T + Woodbury loop correction,
    # valid for ANY loop topology; "banded": exact super-block-tridiagonal
    # solve, REQUIRES max(loop_j - loop_i) <= fixed_interval (true for the
    # pipeline's fixed-interval candidates, reference main.py:158-161) and
    # is much faster there (cost independent of the candidate count);
    # "cg": preconditioned conjugate gradients (models/pose_graph.py)
    solver: str = "direct"
    # Loop-closure proposer: "fixed" (reference parity — pairs
    # (i, i+interval) only, main.py:161); "proximity" (the fixed pairs
    # PLUS revisit pairs from models/slam.proximity_loop_candidates —
    # metric nearness on the estimated trajectory, valid while drift stays
    # under proximity_radius); or "descriptor" (the fixed pairs PLUS
    # appearance-based place recognition: rotation-tolerant per-scan range
    # histograms, all-pairs similarity as one MXU matmul — finds revisits
    # REGARDLESS of accumulated drift, which defeats metric proximity once
    # drift exceeds the search radius). With either extra proposer
    # run_slam forces solver="direct", since revisit spans exceed any
    # fixed band. Pairing with robust_loss is recommended.
    loop_proposer: str = "fixed"
    proximity_radius: float = 0.5       # revisit distance threshold (m) on
    #   the ESTIMATED trajectory — inflate to cover expected drift; false
    #   proposals are culled by the ICP-error gate below
    proximity_min_gap: int = 100        # min steps between revisit pair
    proximity_max_candidates: int = 256
    proximity_suppress: int = 20        # non-max suppression window (steps)
    # Verification seeding for proximity pairs: "identity" (like the
    # reference's loop ICPs, main.py:164 — only works when the revisit
    # heading difference is small) or "estimate" (seed each pair's ICP
    # from the ESTIMATED relative pose — handles ANY heading difference,
    # e.g. driving a loop back the other way; pair with proximity_trim
    # < 1 since opposite-heading scans share only part of their FOV).
    # With "estimate" the acceptance gates change: ICP error <
    # proximity_max_err AND the CORRECTION from the seed is bounded
    # (translation < 2*proximity_radius, yaw < proximity_max_yaw_corr) —
    # the proposer's drift bound is exactly what makes a bounded
    # correction the right gate.
    proximity_seed: str = "identity"
    proximity_trim: float = 1.0         # TrICP fraction for verification
    proximity_max_yaw_corr: float = 20.0  # deg; gate for seeded mode
    # Seeded-mode error gate, RELATIVE to a self-calibrated floor: the
    # median converged trimmed error of the same verification on 32
    # consecutive-scan control pairs (absolute thresholds do not travel
    # across ray densities / room sizes — see
    # models/slam.verify_revisit_pairs_seeded).
    proximity_err_rel: float = 50.0
    # Measured on the reversed-lap scene (drive a circle, turn around,
    # retrace it backwards; tools/revisit_check.py --reverse): seeded
    # trimmed (0.55) verification measures the ~180-degree revisit
    # transforms to 12 mm median, and 10 kept closures improve cross-lap
    # map consistency 4x (133 -> 32 cm) where fixed-interval closures do
    # nothing (130 cm) — tests/test_loop_detection.py.
    # Verification gate: a revisit closure is accepted only if its
    # identity-seeded ICP converges to a normalized error below this.
    # Measured separation on the synthetic revisit scene
    # (tools/revisit_check.py, tests/test_loop_detection.py): the exact
    # revisit converges to ~1e-5, pairs 0.2 m off it stall at 1.5-2.4e-4,
    # perceptually-aliased false matches at 1.3e-3..4.7e-3 — 1e-4 admits
    # only near-exact overlaps with >=10x margin against aliases.
    proximity_max_err: float = 1e-4
    # Descriptor place recognition (loop_proposer="descriptor"):
    # per-scan histogram of valid ranges over descriptor_bins bins — yaw-
    # tolerant (exactly invariant for a 360-degree FOV; tolerant within
    # FOV overlap for the 270-degree Hokuyo). A pair is proposed when its
    # squared descriptor distance is below descriptor_rel_thresh x the
    # MEDIAN CONSECUTIVE-SCAN squared distance (consecutive scans view the
    # same place, so that median is a self-calibrating "same place" scale;
    # measured on the revisit scene: true revisit 0.4x, false matches
    # >=15x — tests/test_loop_detection.py). descriptor_max_dist caps the
    # verified ICP translation (a converged alignment with a huge offset
    # means the overlap was degenerate, not a revisit).
    descriptor_bins: int = 64
    descriptor_rel_thresh: float = 4.0
    descriptor_max_dist: float = 5.0


@dataclasses.dataclass(frozen=True)
class OnlineConfig:
    """Streaming-mode tracking-loss detection + relocalization recovery
    (new surface — the reference is batch-only; this finishes the
    kidnapped-robot story the starter's mapCorrelation gestures at,
    reference: code/pr2_utils.py:12-43).

    The loss signal is the final RMS point-to-correspondence distance of
    the per-step scan match, in METERS — metric- and normalization-
    agnostic (recomputed from the final transform, not the solver's
    objective). Healthy consecutive scans converge to mm-cm RMS; a
    kidnapped robot's scan mismatches at room scale. While RMS exceeds
    loss_rms_thresh the step COASTS on odometry (a garbage ICP result is
    neither composed into the pose nor rasterized into the map); the
    online loop then calls models/online.relocalize_and_reseed.

    The default threshold is inf: detection off, bit-identical to the
    pre-detection streaming behavior.
    """

    loss_rms_thresh: float = float("inf")
    # relocalization search budget (models/relocalization.RelocConfig)
    reloc_beam: int = 4096
    reloc_n_angles: int = 360
    reloc_max_rays: int = 256
    # pose hypotheses polished by batched ICP, lowest normalized error
    # wins (correlative hit counts alias in self-similar rooms; the
    # geometric fit disambiguates — models/relocalization.relocalize_refined)
    reloc_candidates: int = 8


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Scan-filtering settings (reference: main.py:86-87, modules/localization.py:201-250)."""

    dbscan_eps: float = 0.1
    dbscan_min_samples: int = 10
    statistical_k_std: float = 2.0


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    robot: RobotConfig = RobotConfig()
    lidar: LidarConfig = LidarConfig()
    map: MapConfig = MapConfig()
    camera: CameraConfig = CameraConfig()
    icp: IcpConfig = IcpConfig()
    # the SLAM pipeline's loop candidates are fixed-interval by
    # construction (models/slam.py loop_closure_candidates), so it can use
    # the banded exact solver; bare PoseGraphConfig keeps the
    # any-topology "direct" default
    pose_graph: PoseGraphConfig = PoseGraphConfig(solver="banded")
    filter: FilterConfig = FilterConfig()
    online: OnlineConfig = OnlineConfig()
