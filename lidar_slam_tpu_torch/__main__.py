"""CLI of the port: the main path of main.py on PyTorch + CUDA.

    python -m lidar_slam_tpu_torch --mode gtsam --synthetic 4956 --device cuda

Takes main.py's flags for the ported slice (--mode --fixed_interval
--dataset --dataset_path --res --width --height --synthetic --output_dir)
plus --device, and writes main.py's stage artifacts under the same names
in --output_dir (poses_odom_<d>.npy, relative_poses_odom_<d>.npy,
poses_scan_matching_<d>.npy, relative_poses_scan_matching_<d>.npy,
poses_optimized_<d>.npy) and the log-odds grid as
logodds_<mode>_<d>.npy. Flags of capabilities that are not ported yet are
accepted and refused with "not yet ported".
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m lidar_slam_tpu_torch",
        description="Generate an Occupancy Grid Map (PyTorch + CUDA port)")
    p.add_argument("--mode", type=str, default="odom",
                   choices=["odom", "scan_matching", "gtsam"],
                   help="The mode to use for pose estimation")
    p.add_argument("--fixed_interval", type=int, default=10,
                   help="The fixed interval for loop closure")
    p.add_argument("--dataset", type=int, default=20,
                   help="The dataset number")
    p.add_argument("--dataset_path", type=str, default="data/",
                   help="The path to the dataset")
    p.add_argument("--res", type=float, default=0.05,
                   help="The resolution of the map")
    p.add_argument("--width", type=int, default=60,
                   help="The width of the map")
    p.add_argument("--height", type=int, default=60,
                   help="The height of the map")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="Run on an N-step synthetic dataset instead of "
                        "reading npz files")
    p.add_argument("--output_dir", type=str, default="outputs/",
                   help="Directory for stage .npy artifacts")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    # main.py flags of capabilities this port does not have yet
    p.add_argument("--filter_lidar", action="store_true",
                   help="(not yet ported)")
    p.add_argument("--generate_texture_map", action="store_true",
                   help="(not yet ported)")
    p.add_argument("--loop_proposer", type=str, default="fixed",
                   choices=["fixed", "proximity", "descriptor"],
                   help="only 'fixed' is ported")
    p.add_argument("--robust_loss", type=str, default="none",
                   choices=["none", "huber", "cauchy"],
                   help="only 'none' is ported")
    p.add_argument("--icp_metric", type=str, default="point",
                   choices=["point", "point_to_line"],
                   help="only 'point' is ported")
    return p


def _unported(args) -> list[str]:
    out = []
    if args.filter_lidar:
        out.append("--filter_lidar")
    if args.generate_texture_map:
        out.append("--generate_texture_map")
    if args.loop_proposer != "fixed":
        out.append(f"--loop_proposer {args.loop_proposer}")
    if args.robust_loss != "none":
        out.append(f"--robust_loss {args.robust_loss}")
    if args.icp_metric != "point":
        out.append(f"--icp_metric {args.icp_metric}")
    return out


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    unported = _unported(args)
    if unported:
        parser.error(f"not yet ported: {', '.join(unported)}")

    import numpy as np

    from . import sensors
    from .config import MapConfig, SlamConfig
    from .models import slam
    from .utils import io

    device = slam.resolve_device(args.device)
    d = args.dataset
    if args.synthetic:
        # --dataset routes the synthetic generator too, like main.py
        gen = io.synthetic_dataset_21 if d == 21 else io.synthetic_dataset
        data = gen(n_steps=args.synthetic)
        print(f"synthetic dataset, {args.synthetic} steps, {d}-shaped")
    else:
        data = io.load_data(d, io.DATASET_NAMES, args.dataset_path)
    encoder = sensors.Encoder.from_data(data["encoder"])
    lidar = sensors.Lidar.from_data(data["lidar"])
    imu = sensors.Imu.from_data(data["imu"])
    sensors.synchronize_sensors(encoder, imu, lidar, base_sensor_index=0)

    cfg = SlamConfig(map=MapConfig.from_cli(args.res, args.width,
                                            args.height))
    result = slam.run_slam(
        encoder.counts_synced, imu.gyro_synced, lidar.ranges_synced,
        float(lidar.range_min), float(lidar.range_max), mode=args.mode,
        fixed_interval=args.fixed_interval, cfg=cfg, device=device)

    out = args.output_dir
    arts = {f"poses_odom_{d}": result.poses_odom,
            f"relative_poses_odom_{d}": result.relative_poses_odom}
    if result.poses_scan_matching is not None:
        arts[f"poses_scan_matching_{d}"] = result.poses_scan_matching
        arts[f"relative_poses_scan_matching_{d}"] = (
            result.relative_poses_scan_matching)
    if result.poses_optimized is not None:
        arts[f"poses_optimized_{d}"] = result.poses_optimized
        print(f"Added {result.n_loop_closures} loop closures")
    arts[f"logodds_{args.mode}_{d}"] = result.logodds
    for name, arr in arts.items():
        io.save_numpy(np.asarray(arr), os.path.join(out, name + ".npy"))
        print(f"{name}.npy saved at {out}")
    print("stage seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in result.stage_seconds.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
