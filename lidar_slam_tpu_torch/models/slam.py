"""End-to-end SLAM pipeline.

Counterpart of lidar_slam_tpu/models/slam.py::run_slam for the reference's
main path (main.py --mode {odom, scan_matching, gtsam} [--filter_lidar]
with fixed-interval loop closures): scan prep -> [scan filters] ->
odometry -> [batched scan matching] -> [fixed-interval loop-closure ICPs +
banded pose-graph LM] -> log-odds map.

The stages run on the device given to run_slam. Each stage ends by copying
its result to the host (SlamResult holds numpy arrays, like the JAX
package's), so the wall time of every stage is recorded in
SlamResult.stage_seconds at no extra synchronisation.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import SlamConfig
from ..ops import filters
from ..ops import icp as icp_ops
from ..ops import scan as scan_ops
from ..utils import se2
from . import occupancy, odometry, pose_graph, scan_matching


@dataclasses.dataclass
class SlamResult:
    poses_odom: np.ndarray
    relative_poses_odom: np.ndarray
    poses: np.ndarray  # final poses for the selected mode
    poses_scan_matching: Optional[np.ndarray] = None
    relative_poses_scan_matching: Optional[np.ndarray] = None
    poses_optimized: Optional[np.ndarray] = None
    n_loop_closures: int = 0
    logodds: Optional[np.ndarray] = None
    grid_map: Optional[np.ndarray] = None
    # per-stage diagnostics of the port
    scan_matching_iters: Optional[np.ndarray] = None
    loop_accept: Optional[np.ndarray] = None
    loop_iters: Optional[np.ndarray] = None
    lm_iterations: int = 0
    ray_cells: int = 0
    stage_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)


def loop_closure_candidates(n_poses: int, fixed_interval: int) -> np.ndarray:
    """Candidate indices i for closures (i, i + interval)."""
    return np.arange(0, n_poses - fixed_interval, fixed_interval)


def compute_loop_closures_pairs(
    points3: torch.Tensor,
    masks: torch.Tensor,
    loop_i: torch.Tensor,
    loop_j: torch.Tensor,
    max_distance: float,
    max_yaw_deg: float,
    chunk_size: int = 64,
    epsilon: float = 0.01,
    stopping_thresh: float = 1e-4,
):
    """Loop-closure ICPs for (i, j) pairs with the reference's gates
    (main.py:161-172): identity-seeded ICP of scan i onto scan j with the
    NORMALIZED error and epsilon 0.01; accepted when the translation is
    below max_distance and the SIGNED angle in degrees below max_yaw_deg.

    Returns (T2 (B, 3, 3) = T_j^-1 T_i, accept (B,), errors, iters).
    """
    B = loop_i.shape[0]
    if B == 0:
        z = points3.new_zeros((0,))
        return (points3.new_zeros((0, 3, 3)), z.bool(), z,
                z.to(torch.int32))
    seeds = torch.eye(4, dtype=points3.dtype,
                      device=points3.device).expand(B, 4, 4)
    T_icp, errors, iters = scan_matching.icp_all_pairs(
        points3[loop_i], points3[loop_j], masks[loop_i], masks[loop_j],
        seeds, epsilon=epsilon, stopping_thresh=stopping_thresh,
        normalize_error=True, chunk_size=chunk_size)
    T2 = se2.TSE2_from_TSE3(T_icp)
    accept = torch.linalg.vector_norm(T2[:, :2, 2], dim=-1) < max_distance
    angle = torch.atan2(T2[:, 1, 0], T2[:, 0, 0])
    accept = accept & (torch.rad2deg(angle) < max_yaw_deg)
    return T2, accept, errors, iters


def compute_loop_closures(points3, masks, cand: np.ndarray,
                          fixed_interval: int, max_distance: float,
                          max_yaw_deg: float, chunk_size: int = 64):
    """Fixed-interval loop closures: compute_loop_closures_pairs over the
    (i, i + interval) pairs."""
    ci = torch.as_tensor(cand, dtype=torch.int64, device=points3.device)
    return compute_loop_closures_pairs(points3, masks, ci, ci + fixed_interval,
                                       max_distance, max_yaw_deg,
                                       chunk_size=chunk_size)


def _check_supported(mode: str, cfg: SlamConfig) -> None:
    """Refuse what run_slam itself does not run yet; the stages refuse
    their own unported options (ICP metric, pose-graph solver and robust
    loss)."""
    if mode not in ("odom", "scan_matching", "gtsam"):
        raise ValueError(f"unknown mode {mode!r}; known: odom, "
                         "scan_matching, gtsam")
    if cfg.pose_graph.loop_proposer != "fixed":
        raise NotImplementedError(
            f"loop_proposer {cfg.pose_graph.loop_proposer!r} is not yet "
            "ported (only 'fixed')")


def filter_scans(points: torch.Tensor, masks: torch.Tensor,
                 cfg: SlamConfig) -> torch.Tensor:
    """main.py --filter_lidar: the DBSCAN outlier filter, then the pooled
    statistical range filter, as masks (ops/filters.py)."""
    masks = filters.dbscan_filter_scans(
        points, masks, eps=cfg.filter.dbscan_eps,
        min_samples=cfg.filter.dbscan_min_samples)
    return filters.statistical_filter_scans(
        points, masks, k_std=cfg.filter.statistical_k_std)


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent
    (there is no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


def run_slam(
    counts,
    gyro,
    ranges,
    range_min: float,
    range_max: float,
    mode: str = "odom",
    filter_lidar: bool = False,
    fixed_interval: int = 10,
    cfg: SlamConfig = SlamConfig(),
    build_map: bool = True,
    chunk_size: int = 64,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> SlamResult:
    """Run the SLAM pipeline on synchronized sensor arrays.

    counts (N, 4) encoder, gyro (N, 3), ranges (N, n_rays) synchronized
    lidar (numpy arrays or tensors), computed on `device` in `dtype`
    (float32 on the GPU path: the NN kernel takes float32). Modes mirror the
    reference CLI: 'odom', 'scan_matching', 'gtsam'. filter_lidar runs the
    scan filters on the masks first (filter_scans; stage "filter").
    """
    _check_supported(mode, cfg)
    dev = resolve_device(device)
    stage = {}
    t0 = time.perf_counter()

    counts, gyro, ranges = (torch.as_tensor(a, dtype=dtype, device=dev)
                            for a in (counts, gyro, ranges))
    points, masks = scan_ops.scans_to_points(ranges, range_min, range_max,
                                             cfg.lidar)
    if filter_lidar:
        t_f = time.perf_counter()
        masks = filter_scans(points, masks, cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stage["filter"] = time.perf_counter() - t_f
        t0 += stage["filter"]
    max_distance, max_yaw_deg = odometry.max_step_gates(counts, gyro,
                                                        cfg.robot.dt)
    poses_odom, rel_odom = odometry.poses_from_odometry(
        counts, gyro, dt=cfg.robot.dt, return_relative_poses=True)
    result = SlamResult(poses_odom=poses_odom.cpu().numpy(),
                        relative_poses_odom=rel_odom.cpu().numpy(),
                        poses=poses_odom.cpu().numpy())
    final_poses = poses_odom
    t1 = time.perf_counter()
    stage["odometry"] = t1 - t0

    if mode in ("scan_matching", "gtsam"):
        sm = scan_matching.poses_from_scan_matching(
            poses_odom, points, masks, cfg.icp, chunk_size=chunk_size)
        result.poses_scan_matching = sm.poses.cpu().numpy()
        result.relative_poses_scan_matching = sm.relative_poses.cpu().numpy()
        result.scan_matching_iters = sm.iters.cpu().numpy()
        final_poses = sm.poses
        t2 = time.perf_counter()
        stage["scan_matching"] = t2 - t1
        t1 = t2

    if mode == "gtsam":
        pts3 = icp_ops.lift_to_3d(points)
        cand = loop_closure_candidates(int(final_poses.shape[0]),
                                       fixed_interval)
        loop_T, accept, _, loop_iters = compute_loop_closures(
            pts3, masks, cand, fixed_interval, float(max_distance),
            float(max_yaw_deg), chunk_size=chunk_size)
        result.loop_accept = accept.cpu().numpy()
        result.loop_iters = loop_iters.cpu().numpy()
        result.n_loop_closures = int(result.loop_accept.sum())
        t2 = time.perf_counter()
        stage["loop_closures"] = t2 - t1
        # the band must follow the actual loop span (fixed_interval), and
        # the loop measurement is the UNINVERTED ICP output T_j^-1 T_i, as
        # the reference feeds it to BetweenFactorPose2(i, j, .)
        # (main.py:171; harmless under its near-identity gates)
        pg_cfg = dataclasses.replace(cfg.pose_graph,
                                     fixed_interval=fixed_interval)
        ci = torch.as_tensor(cand, dtype=torch.int64, device=dev)
        opt = pose_graph.optimize_trajectory(
            final_poses, sm.relative_poses, ci, ci + fixed_interval, loop_T,
            accept, pg_cfg)
        result.poses_optimized = opt.poses.cpu().numpy()
        result.lm_iterations = opt.iterations
        final_poses = opt.poses
        t3 = time.perf_counter()
        stage["pose_graph"] = t3 - t2
        t1 = t3

    result.poses = final_poses.cpu().numpy()
    if build_map:
        _build_map(result, final_poses, points, masks, cfg, range_max)
        stage["map_build"] = time.perf_counter() - t1
    result.stage_seconds = stage
    return result


def _build_map(result: SlamResult, poses, points, masks, cfg: SlamConfig,
               range_max: float) -> None:
    """The log-odds map of the scans at `poses` (K1 on the card) into
    result.logodds, result.grid_map and result.ray_cells."""
    K = occupancy.adaptive_ray_cells(points, masks, cfg.map, float(range_max))
    logodds = occupancy.build_logodds(poses, points, masks, cfg.map, K)
    result.ray_cells = K
    result.logodds = logodds.cpu().numpy()
    result.grid_map = occupancy.finalize_grid(logodds).cpu().numpy()


def resume_from_poses(
    poses,
    ranges,
    range_min: float,
    range_max: float,
    filter_lidar: bool = False,
    cfg: SlamConfig = SlamConfig(),
    build_map: bool = True,
    device="cuda",
) -> SlamResult:
    """Checkpoint/resume: rebuild the map from a saved pose trajectory
    (N, 3), skipping pose estimation (main.py --load_poses).

    Counterpart of lidar_slam_tpu/models/slam.py::resume_from_poses: the
    poses become poses_odom and poses, their relative transforms
    relative_poses_odom, and the map is built as run_slam builds it (with
    the scan filters under filter_lidar), in float32 on `device`.
    """
    dev = resolve_device(device)
    t0 = time.perf_counter()
    poses, ranges = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                     for a in (poses, ranges))
    points, masks = scan_ops.scans_to_points(ranges, range_min, range_max,
                                             cfg.lidar)
    if filter_lidar:
        masks = filter_scans(points, masks, cfg)
    host = poses.cpu().numpy()
    result = SlamResult(
        poses_odom=host,
        relative_poses_odom=se2.get_relative_pose(poses[:-1],
                                                  poses[1:]).cpu().numpy(),
        poses=host)
    if build_map:
        _build_map(result, poses, points, masks, cfg, range_max)
        result.stage_seconds = {"map_build": time.perf_counter() - t0}
    return result
