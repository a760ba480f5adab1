"""Online (streaming) SLAM: one step per incoming scan.

Counterpart of lidar_slam_tpu/models/online.py, with the same update rule:
the ICP seed is the relative pose of consecutive ODOMETRY poses (reference
modules/localization.py:116-118), the refined relative pose composes onto
the refined chain (:127), and the map update applies the reference's
per-ray log-odds rule with the per-scan clip (modules/ogm.py:149-188). The
map is CAUSAL: each scan is painted at the pose estimated at its step.

The JAX package runs a step as one jitted program with the state DONATED.
Here the state is a NamedTuple of tensors on one device, and a step
consumes it in the same sense: the carried log-odds grid and the history
ring buffers are updated IN PLACE (the grid by the raywalk_scan kernel on
CUDA tensors) and are shared with the returned state, so a step neither
allocates nor copies the 5.8 MB grid. Keep a copy (or a checkpoint) of a
state that must survive the next step.

relocalize_and_reseed() recovers a kidnapped robot: the certified global
search and ICP polish of models/relocalization against the causal map,
then the stream re-seeded at the recovered pose.

refine() smooths the retained window with the pose-graph solve of the gtsam
stage, optionally with gated fixed-interval loop closures from the window's
scans and, under the proximity or descriptor proposer, verified in-window
revisit closures; the causal map is untouched. save_state/load_state use
the JAX package's .npz layout, so a checkpoint resumes in either package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import SlamConfig
from ..ops import icp as icp_ops
from ..utils import interop, se2
from . import occupancy, odometry, pose_graph
from .slam import (compute_loop_closures, loop_closure_candidates,
                   resolve_device, revisit_closures)


class OnlineState(NamedTuple):
    pose: torch.Tensor         # (3,) f32 current refined pose
    odom_pose: torch.Tensor    # (3,) f32 dead-reckoning pose (seed source)
    logodds: torch.Tensor      # (W, H) f32 causal log-odds map
    prev_points: torch.Tensor  # (P, 3) f32 previous scan (z = 0)
    prev_mask: torch.Tensor    # (P,) bool
    step: torch.Tensor         # () int32, 0 before the first step
    # history RING buffers for refine(): slot s % n_max holds step s's pose
    # and the relative SE(2) from step s-1 to s
    poses_hist: torch.Tensor   # (n_max, 3) f32 refined poses
    rel_hist: torch.Tensor     # (n_max, 3, 3) f32 refined relative SE(2)
    # () f32 tracking-health signal: final RMS point-to-correspondence
    # distance (m) of this step's scan match (config.OnlineConfig)
    match_rms: torch.Tensor


def default_ray_cells(cfg: SlamConfig, range_max: float = 30.0) -> int:
    """Per-ray slot budget from the map config and the sensor range
    (occupancy.max_ray_cells): the K init_state/online_step use when none
    is given."""
    return occupancy.max_ray_cells(cfg.map, range_max)


def init_state(first_points, first_mask, cfg: SlamConfig = SlamConfig(),
               n_max: int = 8192, x0=None, K: int | None = None,
               device="cuda") -> OnlineState:
    """State after observing the FIRST scan at the start pose x0 (default
    the origin), on `device` (raises when CUDA is asked for and absent).

    The first scan is painted into a zero map at x0 by update_map (the
    offline build loops over all scans including index 0, reference
    ogm.py:56)."""
    dev = resolve_device(device)
    if K is None:
        K = default_ray_cells(cfg)
    pts3 = icp_ops.lift_to_3d(torch.as_tensor(
        first_points, dtype=torch.float32, device=dev)).contiguous()
    mask = torch.as_tensor(first_mask, dtype=torch.bool,
                           device=dev).contiguous()
    pose0 = (torch.zeros(3, dtype=torch.float32, device=dev) if x0 is None
             else torch.as_tensor(x0, dtype=torch.float32, device=dev))
    logodds = torch.zeros((cfg.map.width, cfg.map.height),
                          dtype=torch.float32, device=dev)
    occupancy.update_map(logodds, pose0, pts3[:, :2], mask, cfg.map, K)
    poses_hist = torch.zeros((n_max, 3), dtype=torch.float32, device=dev)
    poses_hist[0] = pose0
    return OnlineState(
        pose=pose0,
        odom_pose=pose0.clone(),
        logodds=logodds,
        prev_points=pts3,
        prev_mask=mask,
        step=torch.zeros((), dtype=torch.int32, device=dev),
        poses_hist=poses_hist,
        rel_hist=torch.eye(3, dtype=torch.float32,
                           device=dev).repeat(n_max, 1, 1),
        match_rms=torch.zeros((), dtype=torch.float32, device=dev),
    )


def online_step(state: OnlineState, counts, gyro, points, mask,
                cfg: SlamConfig = SlamConfig(),
                K: int | None = None) -> OnlineState:
    """Advance the state by one synchronized sensor tuple: counts (4,)
    encoder ticks, gyro (3,), points (P, 2) or (P, 3) robot-frame scan,
    mask (P,). Consumes `state` (module docstring): its logodds, poses_hist
    and rel_hist are updated in place and returned in the new state. Pass
    the K used at init_state when overriding it. The scan match uses
    cfg.icp.metric."""
    if K is None:
        K = default_ray_cells(cfg)
    dev = state.pose.device
    f32 = dict(dtype=torch.float32, device=dev)
    pts3 = icp_ops.lift_to_3d(torch.as_tensor(points, **f32)).contiguous()
    mask = torch.as_tensor(mask, dtype=torch.bool, device=dev).contiguous()

    # 1. dead-reckoning advance (reference modules/localization.py:60-93)
    v = odometry.v_from_encoder(torch.as_tensor(counts, **f32))
    odom_new = odometry.diff_drive_motion_model(
        state.odom_pose, v, torch.as_tensor(gyro, **f32), cfg.robot.dt)
    seed2 = se2.get_relative_pose(state.odom_pose, odom_new)

    # 2. scan matching against the previous scan (B = 1)
    res = icp_ops.run_icp_batch(
        pts3[None], state.prev_points[None], mask[None],
        state.prev_mask[None], se2.TSE3_from_TSE2(seed2)[None],
        epsilon=cfg.icp.epsilon, max_iters=cfg.icp.max_iters,
        stopping_thresh=cfg.icp.stopping_thresh,
        normalize_error=cfg.icp.normalize_error, metric=cfg.icp.metric)
    rel2 = se2.TSE2_from_TSE3(res.T[0])

    # tracking-health signal in metres under the final transform
    idx_c = res.correspondences[0].long()
    src_t2 = se2.transform_points(pts3[:, :2], rel2)
    matched2 = state.prev_points[idx_c, :2]
    valid_c = mask & state.prev_mask[idx_c]
    d2 = torch.sum((src_t2 - matched2) ** 2, dim=-1)
    rms = torch.sqrt(torch.sum(torch.where(valid_c, d2, torch.zeros_like(d2)))
                     / torch.clamp(torch.sum(valid_c), min=1))

    # tracking-loss gate (config.OnlineConfig): above the threshold the
    # step COASTS on the odometry increment and does not paint the map. A
    # host read of `lost` stands in for the JAX package's lax.cond; with
    # the default infinite threshold the gate (and the read) is skipped.
    lost = (math.isfinite(cfg.online.loss_rms_thresh)
            and bool(rms > cfg.online.loss_rms_thresh))
    if lost:
        rel2 = seed2
    pose_new = se2.pose_from_T(se2.T_from_pose(state.pose) @ rel2)

    # 3. causal map update, in place on the carried grid
    if not lost:
        occupancy.update_map(state.logodds, pose_new, pts3[:, :2], mask,
                             cfg.map, K)

    # ring buffers: slot s % n_max holds step s
    step_new = state.step + 1
    idx = (step_new % state.poses_hist.shape[0]).long().reshape(1)
    state.poses_hist.index_copy_(0, idx, pose_new[None])
    state.rel_hist.index_copy_(0, idx, rel2[None])
    return OnlineState(
        pose=pose_new,
        odom_pose=odom_new,
        logodds=state.logodds,
        prev_points=pts3,
        prev_mask=mask,
        step=step_new,
        poses_hist=state.poses_hist,
        rel_hist=state.rel_hist,
        match_rms=rms,
    )


def relocalize_and_reseed(state: OnlineState, cfg: SlamConfig,
                          K: int | None = None, reloc_cfg=None,
                          paint: bool = True):
    """Kidnapped-robot recovery for the streaming mode (a rare event, not a
    per-step path), on the state's device.

    Runs the certified global search + ICP polish
    (relocalization.relocalize_refined) for the CURRENT scan against the
    CAUSAL map, then re-seeds the stream at the recovered pose: the
    current history slot gets that pose, and the slot's between-factor
    the estimated jump (the kidnap was motion the odometry never measured,
    so refine()'s chain stays consistent across it). The held-out scan,
    which the loss gate did not paint, is painted at the recovered pose by
    update_map when `paint`. Consumes `state` as online_step does (grid
    and ring buffers in place). Returns (new_state, RelocResult,
    icp_error).
    """
    from .relocalization import RelocConfig, relocalize_refined

    if K is None:
        K = default_ray_cells(cfg)
    m = cfg.map
    if reloc_cfg is None:
        # the whole mapped area: centred on the map, radius half its
        # diagonal
        reloc_cfg = RelocConfig(
            search_radius=0.5 * math.hypot(m.world_max_x - m.world_min_x,
                                           m.world_max_y - m.world_min_y),
            beam=cfg.online.reloc_beam,
            n_angles=cfg.online.reloc_n_angles,
            max_rays=cfg.online.reloc_max_rays)
    center = (0.5 * (m.world_min_x + m.world_max_x),
              0.5 * (m.world_min_y + m.world_max_y))
    grid_res, refined, icp_err = relocalize_refined(
        state.logodds, m, state.prev_points[:, :2], state.prev_mask,
        reloc_cfg, center=center,
        n_candidates=cfg.online.reloc_candidates)
    refined = refined.to(torch.float32)

    n_max = state.poses_hist.shape[0]
    step = int(state.step)
    prev_pose = state.poses_hist[(step - 1) % n_max]
    jump = se2.get_relative_pose(prev_pose, refined).to(torch.float32)
    if paint:
        occupancy.update_map(state.logodds, refined,
                             state.prev_points[:, :2], state.prev_mask, m, K)
    state.poses_hist[step % n_max] = refined
    state.rel_hist[step % n_max] = jump
    new_state = state._replace(
        pose=refined,
        match_rms=torch.zeros((), dtype=torch.float32,
                              device=refined.device))
    return new_state, grid_res, icp_err


def window_start(state: OnlineState) -> int:
    """First step index covered by the retained sliding window."""
    return max(0, int(state.step) + 1 - state.poses_hist.shape[0])


def refine(state: OnlineState, cfg: SlamConfig = SlamConfig(),
           scans=None, scan_masks=None, max_distance: float = np.inf,
           max_yaw_deg: float = np.inf,
           descriptor_range: tuple[float, float] = (0.1, 30.0)) -> np.ndarray:
    """Smooth the retained trajectory window with the pose-graph solve of
    the gtsam stage (reference main.py:148-192); returns (n, 3) poses of
    global steps [window_start(state), state.step].

    The window-head pose is anchored at its online estimate under the
    prior noise model: within capacity that is the trajectory start, past
    it the marginalized summary of the evicted chain. With `scans`
    (>= n, P, 2 or 3) and `scan_masks`, the window's scans in chronological
    order (the last n are used), gated fixed-interval loop closures are
    added as in the offline stage; under cfg.pose_graph.loop_proposer
    "proximity" (nearness on the window's poses) or "descriptor" (range
    histograms of the window's points, ||p|| binned over
    `descriptor_range`), in-window revisit closures are also proposed,
    verified and suppressed as offline (slam.revisit_closures), and the
    solve switches to the direct solver once one is kept. Without scans,
    between factors only.
    """
    pg_cfg = cfg.pose_graph
    n_max = state.poses_hist.shape[0]
    step = int(state.step)
    n = min(step + 1, n_max)
    start = step + 1 - n
    dev = state.poses_hist.device
    slots = torch.as_tensor((start + np.arange(n)) % n_max, device=dev)
    poses = state.poses_hist[slots]
    rel = state.rel_hist[slots[1:]]
    interval = pg_cfg.fixed_interval
    loops = {}
    if scans is not None and n > interval + 1:
        if scan_masks is None:
            raise ValueError("refine: scans given without scan_masks")
        if scans.shape[0] < n or scan_masks.shape[0] < n:
            raise ValueError(
                f"refine needs the window's {n} scans+masks "
                f"(chronological), got {scans.shape[0]} scans / "
                f"{scan_masks.shape[0]} masks")
        pts3 = icp_ops.lift_to_3d(torch.as_tensor(
            scans[-n:], dtype=state.poses_hist.dtype, device=dev))
        masks = torch.as_tensor(scan_masks[-n:], dtype=torch.bool,
                                device=dev)
        cand = loop_closure_candidates(n, interval)
        loop_T, accept, _, _ = compute_loop_closures(
            pts3, masks, cand, interval, float(max_distance),
            float(max_yaw_deg))
        li = torch.as_tensor(cand, device=dev)
        lj = li + interval
        if pg_cfg.loop_proposer != "fixed":
            ranges = torch.sqrt(torch.sum(pts3[..., :2] * pts3[..., :2],
                                          dim=-1))
            rv = revisit_closures(pts3, masks, poses, pg_cfg, ranges,
                                  descriptor_range[0], descriptor_range[1])
            if rv.loop_i.numel():
                li, lj, loop_T, accept = rv.append_to(li, lj, loop_T, accept)
                pg_cfg = dataclasses.replace(pg_cfg, solver="direct")
        loops = dict(loop_i=li, loop_j=lj, loop_meas=loop_T,
                     loop_mask=accept)
    graph = pose_graph.make_graph(rel, pg_cfg, prior_pose=poses[0], **loops)
    res = pose_graph.optimize_with_config(poses, graph, pg_cfg)
    return res.poses.cpu().numpy()


def save_state(path: str, state: OnlineState) -> None:
    """Checkpoint the full online state to one .npz, one array per field
    with the JAX package's keys and dtypes, so either package resumes it."""
    np.savez(path, **interop.to_numpy(state._asdict()))


def load_state(path: str, device="cuda") -> OnlineState:
    """Restore a checkpoint written by either package's save_state onto
    `device`. A checkpoint written before match_rms existed resumes with
    match_rms = 0."""
    dev = resolve_device(device)
    defaults = {"match_rms": np.zeros((), np.float32)}
    with np.load(path) as d:
        arrays = {k: (d[k] if k in d.files else defaults[k])
                  for k in OnlineState._fields}
    return OnlineState(**interop.from_numpy(arrays, device=dev))
