"""CLI of the port: the main path of main.py on PyTorch + CUDA.

    python -m lidar_slam_tpu_torch --mode gtsam --synthetic 4956 --device cuda

Takes every flag of main.py under main.py's names, defaults and choices,
plus --device. It writes main.py's stage artifacts under the same names in
--output_dir (poses_odom_<d>.npy, relative_poses_odom_<d>.npy,
poses_scan_matching_<d>.npy, relative_poses_scan_matching_<d>.npy,
poses_optimized_<d>.npy), builds the log-odds map only when main.py does
(--generate_texture_map, --save_logodds or --export_ros_map) and writes
the grid only to --save_logodds. --load_poses X.npy rebuilds the map from
saved poses and skips pose estimation and the stage artifacts.
--filter_lidar runs the scan filters first. --generate_texture_map writes
the log-odds PNG and, on a dataset on disk (its frames under dataRGBD/ in
the working directory), the texture map PNG, under main.py's image paths
(images/ or images_filtered/, suffixed _<mode>_<d>.png); the texture is
painted on --device (main.py's "auto" engine may take its native host
projector, which the port does not have).

Beyond the reference, as main.py: --loop_proposer proximity|descriptor adds
verified revisit closures (with --proximity_seed estimate and
--proximity_trim q for estimate-seeded trimmed verification),
--robust_loss huber|cauchy a robust kernel on the loop factors,
--icp_metric point_to_line PLICP scan matching, --synthetic_revisit N
[--synthetic_laps L] the revisit scene, --export_ros_map STEM the map as a
ROS map_server PGM + YAML and --export_tum PATH the final poses as a TUM
trajectory.
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
    p.add_argument("--filter_lidar", action="store_true",
                   help="Filter the lidar data")
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
    p.add_argument("--logodds_map_path", type=str,
                   default="logodds_map.png",
                   help="The path to save the map")
    p.add_argument("--texture_map_path", type=str,
                   default="texture_map.png",
                   help="The path to save the texture map")
    p.add_argument("--generate_texture_map", action="store_true",
                   help="Generate the texture map")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="Run on an N-step synthetic dataset instead of "
                        "reading npz files")
    p.add_argument("--synthetic_revisit", type=int, default=0, metavar="N",
                   help="Run on an N-step synthetic revisit scene (a "
                        "circle driven --synthetic_laps times)")
    p.add_argument("--synthetic_laps", type=int, default=1,
                   help="Laps for --synthetic_revisit")
    p.add_argument("--output_dir", type=str, default="outputs/",
                   help="Directory for stage .npy artifacts")
    p.add_argument("--save_logodds", type=str, default=None,
                   metavar="PATH.npy",
                   help="Also save the final log-odds grid (.npy); implies "
                        "building the map")
    p.add_argument("--load_poses", type=str, default=None,
                   help="Resume from a saved poses .npy: skip pose "
                        "estimation and only build the map")
    p.add_argument("--loop_proposer", type=str, default="fixed",
                   choices=["fixed", "proximity", "descriptor"],
                   help="loop-closure proposer: the reference's fixed "
                        "interval, or fixed plus verified revisit pairs")
    p.add_argument("--robust_loss", type=str, default="none",
                   choices=["none", "huber", "cauchy"],
                   help="robust m-estimator on the loop factors")
    p.add_argument("--proximity_seed", type=str, default="identity",
                   choices=["identity", "estimate"],
                   help="seed of the revisit verification ICP")
    p.add_argument("--proximity_trim", type=float, default=1.0,
                   help="TrICP fraction of the revisit verification")
    p.add_argument("--icp_metric", type=str, default="point",
                   choices=["point", "point_to_line"],
                   help="ICP metric of scan matching")
    p.add_argument("--export_ros_map", type=str, default=None,
                   metavar="STEM",
                   help="write the map as STEM.pgm + STEM.yaml (ROS "
                        "map_server)")
    p.add_argument("--export_tum", type=str, default=None, metavar="PATH",
                   help="write the final poses as a TUM trajectory")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    return p


def image_paths(args) -> tuple[str, str]:
    """(log-odds map PNG, texture map PNG) as main.py derives them
    (main.py:153-160); --generate_texture_map writes them."""
    img_dir = "images_filtered/" if args.filter_lidar else "images/"
    suffix = f"_{args.mode}_{args.dataset}.png"
    return tuple(img_dir + path.split(".")[0] + suffix
                 for path in (args.logodds_map_path, args.texture_map_path))


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    import dataclasses

    import numpy as np

    from . import sensors
    from .config import MapConfig, SlamConfig
    from .models import slam
    from .utils import export, io

    device = slam.resolve_device(args.device)
    d = args.dataset
    if args.synthetic_revisit:
        data = io.synthetic_revisit_dataset(n_steps=args.synthetic_revisit,
                                            laps=args.synthetic_laps)
        print(f"synthetic revisit scene, {args.synthetic_revisit} steps, "
              f"{args.synthetic_laps} lap(s)")
        args.synthetic = args.synthetic_revisit  # no RGB-D frames either
    elif args.synthetic:
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
    cfg = dataclasses.replace(
        cfg, pose_graph=dataclasses.replace(
            cfg.pose_graph, loop_proposer=args.loop_proposer,
            robust_loss=args.robust_loss, proximity_seed=args.proximity_seed,
            proximity_trim=args.proximity_trim),
        icp=dataclasses.replace(cfg.icp, metric=args.icp_metric))
    # main.py:224-226: the map is built only for an output that reads it
    build_map = (args.generate_texture_map or bool(args.save_logodds)
                 or bool(args.export_ros_map))
    if args.load_poses:
        result = slam.resume_from_poses(
            io.load_numpy(args.load_poses), lidar.ranges_synced,
            float(lidar.range_min), float(lidar.range_max),
            filter_lidar=args.filter_lidar, cfg=cfg, build_map=build_map,
            device=device)
        print(f"(resumed from {args.load_poses})")
    else:
        result = slam.run_slam(
            encoder.counts_synced, imu.gyro_synced, lidar.ranges_synced,
            float(lidar.range_min), float(lidar.range_max), mode=args.mode,
            filter_lidar=args.filter_lidar,
            fixed_interval=args.fixed_interval, cfg=cfg,
            build_map=build_map, device=device)
        _save_stage_artifacts(io, result, args.output_dir, d)
    if args.save_logodds:
        io.save_numpy(result.logodds, args.save_logodds)
        print(f"log-odds grid saved at {args.save_logodds}")
    if args.export_ros_map:
        pgm, yml = export.save_map_ros(result.logodds, cfg.map,
                                       args.export_ros_map)
        print(f"ROS map_server map saved at {pgm} + {yml}")
    if args.export_tum:
        # main.py's pose choice: optimized, else scan-matched, else odometry
        final = next(p for p in (result.poses_optimized,
                                 result.poses_scan_matching,
                                 result.poses_odom) if p is not None)
        stamps = (np.asarray(encoder.stamps)[:final.shape[0]]
                  if len(encoder.stamps) >= final.shape[0] else None)
        export.save_trajectory_tum(args.export_tum, final, stamps)
        print(f"TUM trajectory saved at {args.export_tum}")
    print("stage seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in result.stage_seconds.items()))
    if args.generate_texture_map:
        _generate_maps(args, cfg, result, data, encoder, device)
    return 0


def _generate_maps(args, cfg, result, data, encoder, device) -> None:
    """main.py's _generate_maps: the log-odds PNG (occupancy.py's
    OccupancyGridMap.plot_log_odds_map), then the texture map of the
    dataset's RGB-D frames at the final poses."""
    from . import sensors
    from .models import occupancy, texture
    from .utils.png import write_png

    logodds_path, texture_path = image_paths(args)
    write_png(logodds_path, occupancy.render_logodds(result.logodds))
    print(f"Occupancy (logodds) map saved at: {logodds_path}")
    kinect = sensors.Kinect.from_data(data["rgbd"])
    rgb_pose_idx = sensors.Kinect.get_closest_stamps(encoder.stamps,
                                                     kinect.rgb_stamps)
    disp_for_rgb = sensors.Kinect.get_closest_stamps(kinect.disp_stamps,
                                                     kinect.rgb_stamps)
    if args.synthetic:
        print("(no RGBD frames for synthetic data; skipping texture)")
        return
    tex = texture.generate_texture_map(
        result.poses, rgb_pose_idx, disp_for_rgb, result.grid_map,
        texture.disk_frame_loader(args.dataset, disp_for_rgb), cfg.map,
        cfg.camera, device=device)
    texture.plot_texture_map(tex, texture_path)
    print(f"Texture map saved at: {texture_path}")


def _save_stage_artifacts(io, result, out: str, d: int) -> None:
    arts = {f"poses_odom_{d}": result.poses_odom,
            f"relative_poses_odom_{d}": result.relative_poses_odom}
    if result.poses_scan_matching is not None:
        arts[f"poses_scan_matching_{d}"] = result.poses_scan_matching
        arts[f"relative_poses_scan_matching_{d}"] = (
            result.relative_poses_scan_matching)
    if result.poses_optimized is not None:
        arts[f"poses_optimized_{d}"] = result.poses_optimized
        print(f"Added {result.n_loop_closures} loop closures")
    for name, arr in arts.items():
        io.save_numpy(arr, os.path.join(out, name + ".npy"))
        print(f"{name}.npy saved at {out}")


if __name__ == "__main__":
    sys.exit(main())
