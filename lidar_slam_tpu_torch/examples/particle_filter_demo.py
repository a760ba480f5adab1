"""Particle-filter localization demo, counterpart of
examples/particle_filter_demo.py: build a map from a synthetic run, bias
the odometry, and watch the filter pull the estimate back to ground truth
(the capability the reference's starter mapCorrelation was shipped for,
code/pr2_utils.py:12-43).

    python -m lidar_slam_tpu_torch.examples.particle_filter_demo \
        [--steps 240] [--particles 128] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m lidar_slam_tpu_torch.examples.particle_filter_demo")
    parser.add_argument("--steps", type=int, default=240)
    parser.add_argument("--rays", type=int, default=181)
    parser.add_argument("--particles", type=int, default=128)
    parser.add_argument("--encoder_bias", type=float, default=1.15,
                        help="encoder scale factor simulating calibration "
                             "error (1.0 = unbiased)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (cuda, cuda:1, cpu)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from ..config import LidarConfig, MapConfig
    from ..models import occupancy, odometry
    from ..models import particle_filter as pf
    from ..models.slam import resolve_device
    from ..ops import scan as scan_ops
    from ..utils import io

    dev = resolve_device(args.device)
    map_cfg = MapConfig(resolution=0.1, world_max_x=15, world_min_x=-15,
                        world_max_y=15, world_min_y=-15)
    data = io.synthetic_dataset(n_steps=args.steps, n_rays=args.rays, seed=5)
    f32 = dict(dtype=torch.float32, device=dev)
    gt = torch.as_tensor(data["ground_truth"], **f32)
    counts = torch.as_tensor(data["encoder"]["counts"], **f32)
    gyro = torch.as_tensor(data["imu"]["angular_velocity"], **f32)
    points, masks = scan_ops.scans_to_points(
        torch.as_tensor(data["lidar"]["ranges"], **f32), 0.1, 30.0,
        LidarConfig())

    K = occupancy.adaptive_ray_cells(points, masks, map_cfg, 30.0)
    logodds = occupancy.build_logodds(gt, points, masks, map_cfg, K)
    im = (logodds > 0).to(torch.float32)
    print(f"map: {tuple(im.shape)}, {int(im.sum())} occupied cells")

    gt_np = data["ground_truth"]
    biased = counts * args.encoder_bias
    odo = odometry.poses_from_odometry(biased, gyro).cpu().numpy()
    err_odo = np.linalg.norm(odo[:, :2] - gt_np[:, :2], axis=1)

    poses, aux = pf.localize_particle_filter(
        im, biased, gyro, points, masks, map_cfg,
        pf.PFConfig(n_particles=args.particles), x0=gt[0], device=dev)
    err = np.linalg.norm(poses.cpu().numpy()[:, :2] - gt_np[:, :2], axis=1)

    print(f"dead reckoning (bias {args.encoder_bias}): "
          f"mean {err_odo.mean():.3f} m, final {err_odo[-1]:.3f} m")
    print(f"particle filter ({args.particles} particles): "
          f"mean {err.mean():.3f} m, final {err[-1]:.3f} m, "
          f"{int(aux['resampled'].sum())} resamples")
    return 0


if __name__ == "__main__":
    sys.exit(main())
