"""Revisit loop-closure demo, counterpart of examples/loop_closure_demo.py:
drive a circle back to its start with a biased gyro and run the same scene
through three --mode gtsam configurations, printing the ATE of each stage:

  fixed       the reference's fixed-interval closures only
  proximity   + metric-nearness revisit pairs (rejected here by design:
              the drift exceeds the search radius)
  descriptor  + appearance place recognition (range-histogram
              descriptors), which finds the true revisit

    python -m lidar_slam_tpu_torch.examples.loop_closure_demo \
        [--steps 360] [--gyro_scale 0.97] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m lidar_slam_tpu_torch.examples.loop_closure_demo")
    parser.add_argument("--steps", type=int, default=360)
    parser.add_argument("--rays", type=int, default=541)
    parser.add_argument("--gyro_scale", type=float, default=0.97,
                        help="yaw-rate scale error simulating gyro "
                             "miscalibration (1.0 = unbiased)")
    parser.add_argument("--laps", type=int, default=1,
                        help="laps around the circle (>=2 makes every "
                             "pose a revisit of the previous lap)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (cuda, cuda:1, cpu)")
    args = parser.parse_args(argv)

    import dataclasses

    import numpy as np

    from ..config import IcpConfig, LidarConfig, SlamConfig
    from ..models import slam
    from ..utils import io

    data = io.synthetic_revisit_dataset(n_steps=args.steps,
                                        n_rays=args.rays,
                                        gyro_scale=args.gyro_scale,
                                        laps=args.laps)
    gt = data["ground_truth"]

    def ate(p):
        return float(np.linalg.norm(
            np.asarray(p)[:, :2] - gt[:, :2], axis=1).mean())

    cfg0 = SlamConfig(lidar=LidarConfig(n_rays=args.rays),
                      icp=IcpConfig(epsilon=0.001))
    variants = {
        "fixed": cfg0.pose_graph,
        "proximity": dataclasses.replace(
            cfg0.pose_graph, loop_proposer="proximity",
            proximity_radius=1.0),
        "descriptor": dataclasses.replace(
            cfg0.pose_graph, loop_proposer="descriptor",
            robust_loss="huber"),
    }
    for name, pg in variants.items():
        res = slam.run_slam(
            data["encoder"]["counts"], data["imu"]["angular_velocity"],
            data["lidar"]["ranges"], 0.1, 30.0, mode="gtsam",
            fixed_interval=10, cfg=dataclasses.replace(cfg0, pose_graph=pg),
            build_map=False, chunk_size=16, device=args.device)
        print(f"[{name:10s}] loops={res.n_loop_closures:3d}  "
              f"ATE odom {ate(res.poses_odom):.3f} m | "
              f"scan-matching {ate(res.poses_scan_matching):.3f} m | "
              f"optimized {ate(res.poses_optimized):.3f} m")
    return 0


if __name__ == "__main__":
    sys.exit(main())
