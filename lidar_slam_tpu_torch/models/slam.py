"""End-to-end SLAM pipeline.

Counterpart of lidar_slam_tpu/models/slam.py::run_slam (main.py --mode
{odom, scan_matching, gtsam} [--filter_lidar]): scan prep -> [scan
filters] -> odometry -> [batched scan matching] -> [fixed-interval
loop-closure ICPs, revisit closures, pose-graph LM] -> log-odds map.

Revisit closures (PoseGraphConfig.loop_proposer "proximity" or
"descriptor") go beyond the reference: pairs proposed by nearness on the
scan-matching estimate or by range-histogram descriptors (all-pairs
distances and the k nearest per scan on the device; ordering, the cap and
suppression on the host), verified by ICP (identity- or estimate-seeded,
optionally trimmed) under the ICP-error gate, suppressed after
verification, and added to the graph solved by the direct solver.

The stages run on the device given to run_slam. Each stage ends by copying
its result to the host (SlamResult holds numpy arrays, like the JAX
package's), so the wall time of every stage is recorded in
SlamResult.stage_seconds at no extra synchronisation.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, NamedTuple, Optional

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
    revisit_proposed: int = 0  # revisit pairs proposed
    revisit_pairs: Optional[np.ndarray] = None  # (K, 2) kept (i, j)
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
    gate_yaw: bool = True,
    seed_T: torch.Tensor | None = None,
    trim_fraction: float = 1.0,
    epsilon: float = 0.01,
    stopping_thresh: float = 1e-4,
):
    """Loop-closure ICPs for (i, j) pairs with the reference's gates
    (main.py:161-172): ICP of scan i onto scan j with the NORMALIZED error
    and epsilon 0.01; accepted when the translation is below max_distance
    and (gate_yaw) the SIGNED angle in degrees below max_yaw_deg.

    seed_T (B, 3, 3) SE(2) seeds replace the identity seeds; with seeds
    the translation gate applies to the correction |t - t_seed|.
    trim_fraction < 1 runs trimmed ICP. Seeded verification needs
    converged measurements and passes tight epsilon and stopping_thresh.
    Returns (T2 (B, 3, 3) = T_j^-1 T_i, accept (B,), errors, iters).
    """
    B = loop_i.shape[0]
    if B == 0:
        z = points3.new_zeros((0,))
        return (points3.new_zeros((0, 3, 3)), z.bool(), z,
                z.to(torch.int32))
    if seed_T is None:
        seeds = torch.eye(4, dtype=points3.dtype,
                          device=points3.device).expand(B, 4, 4)
    else:
        seed_T = seed_T.to(points3.dtype)
        seeds = se2.TSE3_from_TSE2(seed_T)
    T_icp, errors, iters = scan_matching.icp_all_pairs(
        points3[loop_i], points3[loop_j], masks[loop_i], masks[loop_j],
        seeds, epsilon=epsilon, stopping_thresh=stopping_thresh,
        normalize_error=True, chunk_size=chunk_size,
        trim_fraction=trim_fraction)
    T2 = se2.TSE2_from_TSE3(T_icp)
    t = T2[:, :2, 2] if seed_T is None else T2[:, :2, 2] - seed_T[:, :2, 2]
    accept = torch.linalg.vector_norm(t, dim=-1) < max_distance
    if gate_yaw:
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


def _k_smallest(d2: torch.Tensor, k: int):
    """Per row, the k smallest entries and their columns, ascending, the
    lower column first on ties (jax.lax.top_k's order): a stable sort."""
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return idx[:, :k], vals[:, :k]


def _nearest_revisits(pos: torch.Tensor, min_gap: int, k: int):
    """Per pose j: indices and squared distances of the k nearest poses i
    with j - i >= min_gap, from one (N, N) distance computation."""
    n = pos.shape[0]
    d2 = torch.sum((pos[:, None, :] - pos[None, :, :]) ** 2, dim=-1)
    ar = torch.arange(n, device=pos.device)
    d2 = torch.where((ar[None, :] - ar[:, None]) >= min_gap, d2,
                     torch.full_like(d2, np.inf))
    return _k_smallest(d2.T, k)


def _rank_and_cap(idx: np.ndarray, d2: np.ndarray, thresh: float,
                  max_candidates: int, suppress_window: int):
    """Host side of both proposers: the (i, j) pairs with d2 <= thresh,
    nearest first (stable), and, when more than max_candidates qualify, a
    light distance-ranked suppression (window suppress_window // 4) so one
    dense neighbourhood cannot crowd distant revisits out of the cap."""
    jj, kk = np.where(d2 <= thresh)
    order = np.argsort(d2[jj, kk], kind="stable")
    cand_i = idx[jj, kk][order].astype(np.int64)
    cand_j = jj[order].astype(np.int64)
    if cand_j.size > max_candidates:
        light = max(1, suppress_window // 4)
        keep = _suppress_greedy(cand_i, cand_j, light, max_candidates)
        cand_i, cand_j = cand_i[keep], cand_j[keep]
    return cand_i.astype(np.int32), cand_j.astype(np.int32)


def proximity_loop_candidates(poses, min_gap: int = 100,
                              radius: float = 0.5,
                              max_candidates: int = 256,
                              suppress_window: int = 20, k: int = 4):
    """Revisit pairs (i, j) by proximity: pose j passed within `radius` of
    a pose i at least `min_gap` steps earlier, on the ESTIMATED trajectory
    (N, 3) (a tensor: the distances run on its device). Each j contributes
    its k nearest valid i, since under drift the true revisit can sit
    behind an aliased match; suppression waits for verification
    (suppress_verified_pairs) except under cap pressure. Returns (loop_i,
    loop_j) int32 numpy arrays, possibly empty."""
    pos = torch.as_tensor(poses)[:, :2].to(torch.float32)
    n = int(pos.shape[0])
    if n <= min_gap:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32))
    idx, d2 = _nearest_revisits(pos, int(min_gap), min(k, n))
    return _rank_and_cap(idx.cpu().numpy(), d2.cpu().numpy(),
                         radius * radius, max_candidates, suppress_window)


def scan_descriptors(ranges: torch.Tensor, masks: torch.Tensor,
                     range_min: float, range_max: float,
                     n_bins: int = 64) -> torch.Tensor:
    """Per-scan place-recognition descriptor (N, n_bins): the normalized
    histogram of valid ranges over n_bins bins of [range_min, range_max].
    Yaw-tolerant (a rotation permutes which ray sees which range). A ray's
    bin is trunc((r - lo) / (hi - lo) * n_bins), clipped, in float32 as
    the JAX package computes it; the counts are integers, so the histogram
    does not depend on the order of its adds."""
    r = ranges.to(torch.float32)
    lo = torch.tensor(range_min, dtype=torch.float32, device=r.device)
    hi = torch.tensor(range_max, dtype=torch.float32, device=r.device)
    idx = torch.clamp(((r - lo) / (hi - lo) * n_bins).to(torch.int32), 0,
                      n_bins - 1)
    h = torch.zeros((r.shape[0], n_bins), dtype=torch.float32,
                    device=r.device)
    h.scatter_add_(1, idx.long(), masks.to(torch.float32))
    return h / torch.clamp(h.sum(dim=-1, keepdim=True), min=1.0)


def _median(v: torch.Tensor) -> torch.Tensor:
    """jnp.median's rule: the midpoint (lo + hi) * 0.5 of the two middle
    order statistics (the one middle value when the count is odd)."""
    s = torch.sort(v).values
    m = s.shape[0] - 1
    return (s[m // 2] + s[(m + 1) // 2]) * 0.5


def _nearest_descriptor_revisits(desc: torch.Tensor, min_gap: int, k: int):
    """Per scan j: indices and squared descriptor distances of the k most
    similar scans i with j - i >= min_gap, plus the median squared distance
    of consecutive scans (the self-calibrating 'same place' scale). The
    all-pairs distance is one (N, B) x (B, N) float32 matmul."""
    n = desc.shape[0]
    n2 = torch.sum(desc * desc, dim=-1)
    g = desc @ desc.T
    d2 = torch.clamp(n2[:, None] + n2[None, :] - 2.0 * g, min=0.0)
    cons = _median(torch.diagonal(d2, offset=1))
    ar = torch.arange(n, device=desc.device)
    d2m = torch.where((ar[None, :] - ar[:, None]) >= min_gap, d2,
                      torch.full_like(d2, np.inf))
    idx, vals = _k_smallest(d2m.T, k)
    return idx, vals, cons


def descriptor_loop_candidates(ranges, masks, range_min: float,
                               range_max: float, min_gap: int = 100,
                               k: int = 4, n_bins: int = 64,
                               rel_thresh: float = 4.0,
                               max_candidates: int = 256,
                               suppress_window: int = 20):
    """Revisit pairs by appearance: scans i and j at least min_gap apart
    whose squared descriptor distance is at most rel_thresh x the median
    consecutive-scan distance. Needs no pose estimate, so it finds revisits
    whatever the drift. ranges and masks (N, R) tensors (the descriptors
    and distances run on their device); ordered most similar first and
    capped as the proximity proposer. Returns int32 numpy (loop_i,
    loop_j)."""
    desc = scan_descriptors(torch.as_tensor(ranges), torch.as_tensor(masks),
                            float(range_min), float(range_max),
                            n_bins=int(n_bins))
    idx, d2, cons = _nearest_descriptor_revisits(desc, int(min_gap), int(k))
    return _rank_and_cap(idx.cpu().numpy(), d2.cpu().numpy(),
                         float(rel_thresh) * float(cons), max_candidates,
                         suppress_window)


def _suppress_greedy(loop_i, loop_j, window, cap):
    """Greedy pair NMS in the given order: a pair is dropped when an
    already-kept pair is within `window` steps on BOTH endpoints. Returns
    the kept positions (host code)."""
    sel = []
    for m in range(loop_i.size):
        i, j = int(loop_i[m]), int(loop_j[m])
        if any(abs(j - int(loop_j[s])) <= window
               and abs(i - int(loop_i[s])) <= window for s in sel):
            continue
        sel.append(m)
        if len(sel) >= cap:
            break
    return np.asarray(sel, np.int64)


def suppress_verified_pairs(loop_i, loop_j, errors, accept,
                            window: int) -> np.ndarray:
    """Post-verification NMS: among ACCEPTED pairs, keep them in ascending
    ICP-error order, dropping any within `window` steps of a kept pair on
    BOTH endpoints. Returns a boolean keep mask over all pairs."""
    loop_i, loop_j = np.asarray(loop_i), np.asarray(loop_j)
    errors, accept = np.asarray(errors), np.asarray(accept)
    keep = np.zeros(loop_i.shape[0], bool)
    acc_pos = np.where(accept)[0]
    order = acc_pos[np.argsort(errors[acc_pos], kind="stable")]
    kept = _suppress_greedy(loop_i[order], loop_j[order], window,
                            cap=order.size)
    keep[order[kept]] = True
    return keep


def verify_revisit_pairs_seeded(pts3, masks, pli, plj, est_poses, pg,
                                chunk_size: int = 64):
    """Prior-seeded trimmed verification (proximity_seed="estimate"): each
    pair's ICP is seeded from the ESTIMATED relative pose and run to
    convergence (epsilon 1e-9, stop 1e-8) with trim pg.proximity_trim.
    Accepted when the correction from the seed is bounded (translation <
    2 * proximity_radius, wrapped yaw < proximity_max_yaw_corr degrees) and
    the converged error is below proximity_err_rel x the median error of
    the same verification on 32 consecutive-scan control pairs (a
    self-calibrated noise floor). Returns (pT (B, 3, 3) tensor in the ICP
    convention T_j^-1 T_i, accept, errors) with numpy accept and errors."""
    dev = pts3.device
    est = torch.as_tensor(est_poses, device=dev)
    li = torch.as_tensor(pli, dtype=torch.int64, device=dev)
    lj = torch.as_tensor(plj, dtype=torch.int64, device=dev)
    seed2 = se2.get_relative_pose(est[lj], est[li])
    max_dist = 2.0 * pg.proximity_radius
    kw = dict(chunk_size=chunk_size, gate_yaw=False,
              trim_fraction=float(pg.proximity_trim), epsilon=1e-9,
              stopping_thresh=1e-8)
    pT, pacc, perr, _ = compute_loop_closures_pairs(
        pts3, masks, li, lj, float(max_dist), 0.0, seed_T=seed2, **kw)
    n = int(est.shape[0])
    cidx = torch.as_tensor(
        np.linspace(0, n - 2, min(32, n - 1)).astype(np.int32),
        dtype=torch.int64, device=dev)
    cs2 = se2.get_relative_pose(est[cidx + 1], est[cidx])
    _, _, cerr, _ = compute_loop_closures_pairs(
        pts3, masks, cidx, cidx + 1, float(max_dist), 0.0, seed_T=cs2, **kw)
    scale = float(np.median(cerr.cpu().numpy()))
    perr = perr.cpu().numpy()
    accept = pacc.cpu().numpy() & (perr < pg.proximity_err_rel * scale)
    pT_np, s_np = pT.cpu().numpy(), seed2.cpu().numpy()
    dyaw = (np.arctan2(pT_np[:, 1, 0], pT_np[:, 0, 0])
            - np.arctan2(s_np[:, 1, 0], s_np[:, 0, 0]))
    dyaw = np.abs((dyaw + np.pi) % (2 * np.pi) - np.pi)
    accept = accept & (np.degrees(dyaw) < pg.proximity_max_yaw_corr)
    return pT, accept, perr


class RevisitClosures(NamedTuple):
    loop_i: torch.Tensor  # (K,) kept revisit pairs
    loop_j: torch.Tensor
    meas: torch.Tensor  # (K, 3, 3) T_i^-1 T_j, the loop residual's convention
    proposed: int  # pairs proposed before verification

    def append_to(self, loop_i, loop_j, meas, mask):
        """The loop factor arrays with these closures appended, live."""
        return (torch.cat([loop_i, self.loop_i]),
                torch.cat([loop_j, self.loop_j]),
                torch.cat([meas, self.meas]),
                torch.cat([mask, torch.ones_like(self.loop_i,
                                                 dtype=torch.bool)]))


def revisit_closures(pts3, masks, poses, pg, ranges, range_min: float,
                     range_max: float,
                     chunk_size: int = 64) -> RevisitClosures:
    """The revisit closures of pg.loop_proposer ("proximity" on `poses`,
    or "descriptor" on `ranges` binned over [range_min, range_max]):
    proposed, verified (seeded under proximity_seed="estimate", else
    identity-seeded with the proximity_max_err gate on the normalized ICP
    error), then suppressed by error rank. The measurements are the
    INVERTED ICP output: ICP of scan i onto scan j gives T_j^-1 T_i, the
    loop residual wants T_i^-1 T_j, and revisit transforms are far from
    identity, where the uninverted one corrupts translation by up to 2|t|
    (the fixed path keeps the reference's uninverted measurement)."""
    dev = pts3.device
    if pg.loop_proposer == "proximity":
        pli, plj = proximity_loop_candidates(
            poses, min_gap=pg.proximity_min_gap, radius=pg.proximity_radius,
            max_candidates=pg.proximity_max_candidates,
            suppress_window=pg.proximity_suppress)
        max_dist = 2.0 * pg.proximity_radius
        seeded = pg.proximity_seed == "estimate"
    elif pg.loop_proposer == "descriptor":
        pli, plj = descriptor_loop_candidates(
            ranges, masks, float(range_min), float(range_max),
            min_gap=pg.proximity_min_gap, n_bins=pg.descriptor_bins,
            rel_thresh=pg.descriptor_rel_thresh,
            max_candidates=pg.proximity_max_candidates,
            suppress_window=pg.proximity_suppress)
        max_dist = pg.descriptor_max_dist
        seeded = False
    else:
        raise ValueError(f"unknown loop proposer {pg.loop_proposer!r}")
    none = torch.zeros(0, dtype=torch.int64, device=dev)
    out = RevisitClosures(none, none, pts3.new_zeros((0, 3, 3)), pli.size)
    if not pli.size:
        return out
    if seeded:
        pT, pacc, perr = verify_revisit_pairs_seeded(
            pts3, masks, pli, plj, poses, pg, chunk_size=chunk_size)
    else:
        li = torch.as_tensor(pli, dtype=torch.int64, device=dev)
        lj = torch.as_tensor(plj, dtype=torch.int64, device=dev)
        pT, pacc, perr, _ = compute_loop_closures_pairs(
            pts3, masks, li, lj, float(max_dist), 0.0,
            chunk_size=chunk_size, gate_yaw=False)
        perr = perr.cpu().numpy()
        # aliased false revisits pass the translation test but stall at a
        # high ICP error
        pacc = pacc.cpu().numpy() & (perr < pg.proximity_max_err)
    keep = suppress_verified_pairs(pli, plj, perr, pacc,
                                   pg.proximity_suppress)
    if not keep.any():
        return out
    sel = np.where(keep)[0]
    sel_t = torch.as_tensor(sel, device=dev)
    return RevisitClosures(
        torch.as_tensor(pli[sel], dtype=torch.int64, device=dev),
        torch.as_tensor(plj[sel], dtype=torch.int64, device=dev),
        se2.inverse_T(pT[sel_t]), pli.size)


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
    scan filters on the masks first (filter_scans; stage "filter"). With
    cfg.pose_graph.loop_proposer "proximity" or "descriptor", the gtsam
    mode adds verified revisit closures (revisit_closures; stage
    "revisit") and solves with the direct solver once one is kept.
    """
    if mode not in ("odom", "scan_matching", "gtsam"):
        raise ValueError(f"unknown mode {mode!r}; known: odom, "
                         "scan_matching, gtsam")
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
        t2 = time.perf_counter()
        stage["loop_closures"] = t2 - t1
        # the band must follow the actual loop span (fixed_interval), and
        # the fixed loops' measurement is the UNINVERTED ICP output
        # T_j^-1 T_i, as the reference feeds it to BetweenFactorPose2(i, j,
        # .) (main.py:171; harmless under its near-identity gates)
        pg_cfg = dataclasses.replace(cfg.pose_graph,
                                     fixed_interval=fixed_interval)
        li = torch.as_tensor(cand, dtype=torch.int64, device=dev)
        lj = li + fixed_interval
        if pg_cfg.loop_proposer != "fixed":
            rv = revisit_closures(pts3, masks, final_poses, pg_cfg, ranges,
                                  range_min, range_max,
                                  chunk_size=chunk_size)
            result.revisit_proposed = rv.proposed
            result.revisit_pairs = torch.stack(
                [rv.loop_i, rv.loop_j], dim=-1).cpu().numpy()
            if rv.loop_i.numel():
                li, lj, loop_T, accept = rv.append_to(li, lj, loop_T, accept)
                # revisit spans exceed any fixed band
                pg_cfg = dataclasses.replace(pg_cfg, solver="direct")
            t3 = time.perf_counter()
            stage["revisit"] = t3 - t2
            t2 = t3
        result.n_loop_closures = int(accept.sum())
        opt = pose_graph.optimize_trajectory(
            final_poses, sm.relative_poses, li, lj, loop_T, accept, pg_cfg)
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
