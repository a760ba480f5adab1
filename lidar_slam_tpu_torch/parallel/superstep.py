"""The fused multi-rank SLAM step.

Counterpart of lidar_slam_tpu/parallel/superstep.py. One step takes a
window of scans and returns refined poses and the updated map, the whole
compute pattern of the pipeline over a 2-D rank mesh:

  - axis "dp": scan pairs (ICP, sharding.sharded_icp_batch, which runs K4
    in every ICP iteration on the card);
  - axis "rp": rays within each scan (sharding.sharded_build_logodds: K2
    deltas psum-combined, then the per-scan clip).

The chain and the Levenberg-Marquardt solve run replicated on every rank,
as in the JAX package. parallel/dryrun.dryrun_multichip runs it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import IcpConfig, MapConfig, PoseGraphConfig
from ..models import pose_graph
from ..models.scan_matching import pad_pairs
from ..utils import se2
from .mesh import Mesh
from .sharding import sharded_build_logodds, sharded_icp_batch


class SuperStepOut(NamedTuple):
    poses: torch.Tensor
    logodds: torch.Tensor
    icp_errors: torch.Tensor
    graph_cost: torch.Tensor


def make_slam_step(mesh: Mesh, map_cfg: MapConfig, K: int,
                   icp_cfg: IcpConfig = IcpConfig(),
                   pg_cfg: PoseGraphConfig = PoseGraphConfig(),
                   map_backend: str = "auto"):
    """Build the multi-rank SLAM step: step(points (N, R, 3), masks (N, R),
    odom_poses (N, 3), logodds (W, H)) -> SuperStepOut, every input whole
    on every rank. R must be a multiple of the "rp" axis (pad rays with
    mask=False). The N - 1 pairs are padded to a multiple of "dp" as scan
    matching pads its chunks (scan_matching.pad_pairs); the padding pairs'
    results are dropped. map_backend as occupancy.build_logodds takes it
    ("auto": K2 on CUDA tensors)."""
    icp = sharded_icp_batch(mesh, "dp")
    build = sharded_build_logodds(mesh, map_cfg, K, axis="rp",
                                  backend=map_backend)
    dp = mesh.size("dp")

    def step(points, masks, odom_poses, logodds):
        # batched ICP over consecutive pairs (dp-parallel)
        seeds3 = se2.TSE3_from_TSE2(se2.get_relative_pose(odom_poses[:-1],
                                                          odom_poses[1:]))
        n_pairs = points.shape[0] - 1
        res = icp(*pad_pairs(points[1:], points[:-1], masks[1:],
                             masks[:-1], seeds3, dp),
                  epsilon=icp_cfg.epsilon, max_iters=icp_cfg.max_iters,
                  stopping_thresh=icp_cfg.stopping_thresh, planar=True)
        rel2 = se2.TSE2_from_TSE3(res.T[:n_pairs])
        chain = se2.compose_chain(rel2, se2.T_from_pose(odom_poses[0]))
        poses = se2.pose_from_T(chain)

        # pose-graph refinement (replicated; one LM solve)
        graph = pose_graph.make_graph(rel2, pg_cfg,
                                      prior_pose=odom_poses[0])
        opt = pose_graph.optimize(poses, graph,
                                  max_iters=pg_cfg.max_lm_iters,
                                  cg_iters=pg_cfg.cg_iters,
                                  lambda_init=pg_cfg.lambda_init,
                                  lambda_up=pg_cfg.lambda_up,
                                  lambda_down=pg_cfg.lambda_down,
                                  solver=getattr(pg_cfg, "solver", "direct"))

        # map update (rp-parallel rays, psum-combined, per-scan clip)
        grid = build(opt.poses, points[..., :2], masks, init=logodds)
        return SuperStepOut(poses=opt.poses, logodds=grid,
                            icp_errors=res.error[:n_pairs],
                            graph_cost=opt.cost)

    return step
