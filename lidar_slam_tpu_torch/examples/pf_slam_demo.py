"""Particle-filter SLAM demo, counterpart of examples/pf_slam_demo.py: no
prior map; the filter localizes against the occupancy map it builds as it
goes, bounding the drift of a deliberately biased odometry (the full-SLAM
counterpart of particle_filter_demo, which localizes in a known map; see
models/pf_slam.py).

    python -m lidar_slam_tpu_torch.examples.pf_slam_demo \
        [--steps 240] [--particles 128] [--map_out map.npy] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m lidar_slam_tpu_torch.examples.pf_slam_demo")
    parser.add_argument("--steps", type=int, default=240)
    parser.add_argument("--rays", type=int, default=181)
    parser.add_argument("--particles", type=int, default=128)
    parser.add_argument("--encoder_bias", type=float, default=1.15,
                        help="encoder scale factor simulating calibration "
                             "error (1.0 = unbiased)")
    parser.add_argument("--map_out", type=str, default=None,
                        help="optional .npy path for the final log-odds map")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (cuda, cuda:1, cpu)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from ..config import LidarConfig, MapConfig
    from ..models import occupancy, odometry, pf_slam
    from ..models.particle_filter import PFConfig
    from ..models.slam import resolve_device
    from ..ops import scan as scan_ops
    from ..utils import io

    dev = resolve_device(args.device)
    map_cfg = MapConfig(resolution=0.1, world_max_x=15, world_min_x=-15,
                        world_max_y=15, world_min_y=-15)
    data = io.synthetic_dataset(n_steps=args.steps, n_rays=args.rays, seed=5)
    f32 = dict(dtype=torch.float32, device=dev)
    gt = torch.as_tensor(data["ground_truth"], **f32)
    counts = torch.as_tensor(data["encoder"]["counts"],
                             **f32) * args.encoder_bias
    gyro = torch.as_tensor(data["imu"]["angular_velocity"], **f32)
    points, masks = scan_ops.scans_to_points(
        torch.as_tensor(data["lidar"]["ranges"], **f32), 0.1, 30.0,
        LidarConfig())
    K = occupancy.adaptive_ray_cells(points, masks, map_cfg, 30.0)

    gt_np = data["ground_truth"]
    odo = odometry.poses_from_odometry(counts, gyro, x_0=gt[0]).cpu().numpy()
    err_odo = np.linalg.norm(odo[:, :2] - gt_np[:, :2], axis=1)

    poses, logodds, aux = pf_slam.slam_particle_filter(
        counts, gyro, points, masks, map_cfg,
        PFConfig(n_particles=args.particles), x0=gt[0], K=K, device=dev)
    err = np.linalg.norm(poses.cpu().numpy()[:, :2] - gt_np[:, :2], axis=1)

    lo = logodds.cpu().numpy()
    print(f"map built: {lo.shape}, {int((lo > 0).sum())} occupied cells")
    print(f"dead reckoning (bias {args.encoder_bias}): "
          f"mean {err_odo.mean():.3f} m, final {err_odo[-1]:.3f} m")
    print(f"pf-slam ({args.particles} particles, no prior map): "
          f"mean {err.mean():.3f} m, final {err[-1]:.3f} m, "
          f"{int(aux['resampled'].sum())} resamples")
    if args.map_out:
        np.save(args.map_out, lo)
        print(f"log-odds map saved to {args.map_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
