"""CLI of the port's online (streaming) SLAM mode: the serving entry.

    python -m lidar_slam_tpu_torch.online_slam --synthetic 500 --device cuda
    python -m lidar_slam_tpu_torch.online_slam --dataset 20 --dataset_path data/
    python -m lidar_slam_tpu_torch.online_slam --synthetic 500 \
        --checkpoint ck.npz --resume

Counterpart of online_slam.py: it feeds one synchronized (encoder, gyro,
scan) tuple at a time through models/online.online_step, with optional
periodic sliding-window refinement and checkpoint/resume. It takes the same
flags with the same defaults and validation messages, plus --device, and
writes the same outputs: the causal map as a PNG (--map_path) and, with
--export_ros_map STEM, as a ROS map_server PGM + YAML, the pose track
including step 0 (--poses_path, .npy) and the checkpoint.
--refine_loops proximity|descriptor adds verified in-window revisit
closures to the refinement, --robust_loss huber|cauchy a robust kernel on
its loop factors, --icp_metric point_to_line PLICP scan matching. The
flags of relocalization and particle-filter localization, which are not
ported yet (--localize, --global_init, --relocalize_on_loss), are refused
with "not yet ported".
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m lidar_slam_tpu_torch.online_slam",
        description="Streaming SLAM (serving mode, PyTorch + CUDA port)")
    p.add_argument("--dataset", type=int, default=20)
    p.add_argument("--dataset_path", type=str, default="data/")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="run on an N-step synthetic stream instead of npz")
    p.add_argument("--res", type=float, default=0.05)
    p.add_argument("--width", type=int, default=60)
    p.add_argument("--height", type=int, default=60)
    p.add_argument("--window", type=int, default=None,
                   help="sliding-window capacity (n_max poses retained); "
                        "default 8192. Ignored with --resume (the "
                        "checkpoint's ring buffers fix the window)")
    p.add_argument("--refine_every", type=int, default=0, metavar="S",
                   help="run the sliding-window pose-graph refinement "
                        "every S steps (0 = never)")
    p.add_argument("--refine_loops", type=str, default="none",
                   choices=["none", "fixed", "proximity", "descriptor"],
                   help="loop closures inside the periodic refinement: "
                        "'none' = between factors only; 'fixed' = gated "
                        "fixed-interval closures over the window's scans; "
                        "'proximity' and 'descriptor' add verified "
                        "in-window revisit closures")
    p.add_argument("--robust_loss", type=str, default="none",
                   choices=["none", "huber", "cauchy"],
                   help="robust m-estimator on loop factors in refine")
    p.add_argument("--icp_metric", type=str, default="point",
                   choices=["point", "point_to_line"],
                   help="ICP correspondence metric")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="write the full online state here at the end "
                        "(and every --refine_every steps)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint instead of starting fresh")
    p.add_argument("--relocalize_on_loss", action="store_true",
                   help="(not yet ported)")
    p.add_argument("--loss_rms", type=float, default=0.3,
                   help="tracking-loss threshold for --relocalize_on_loss: "
                        "RMS point-to-correspondence distance in meters")
    p.add_argument("--map_path", type=str, default="online_map.png")
    p.add_argument("--export_ros_map", type=str, default=None, metavar="STEM",
                   help="also write the causal map as STEM.pgm + "
                        "STEM.yaml (ROS map_server)")
    p.add_argument("--poses_path", type=str, default=None,
                   help="save the streamed pose track (.npy)")
    p.add_argument("--localize", type=str, default=None, metavar="MAP.npy",
                   help="(not yet ported)")
    p.add_argument("--particles", type=int, default=256,
                   help="particle count for --localize")
    p.add_argument("--x0", type=str, default=None, metavar="X,Y,YAW",
                   help="initial pose for --localize (default 0,0,0)")
    p.add_argument("--global_init", action="store_true",
                   help="(not yet ported)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    return p


def _unported(args) -> list[str]:
    return [flag for flag, on in (
        ("--localize", args.localize is not None),
        ("--global_init", args.global_init),
        ("--relocalize_on_loss", args.relocalize_on_loss)) if on]


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    unported = _unported(args)
    if unported:
        parser.error(f"not yet ported: {', '.join(unported)}")

    if args.resume:
        # a missing checkpoint under --resume must not fall through to a
        # fresh run, whose final save would overwrite the path the operator
        # believed held their state; checked before any data work
        if not args.checkpoint:
            raise SystemExit("--resume requires --checkpoint")
        if not os.path.exists(args.checkpoint):
            raise SystemExit(
                f"--resume: checkpoint {args.checkpoint!r} does not exist "
                "(refusing to start fresh and overwrite it; drop --resume "
                "for a new run)")

    import dataclasses

    import numpy as np
    import torch

    from . import sensors
    from .config import MapConfig, SlamConfig
    from .models import occupancy, odometry, online, slam
    from .ops import scan as scan_ops
    from .utils import io
    from .utils.png import write_png

    dev = slam.resolve_device(args.device)
    cfg = SlamConfig(map=MapConfig.from_cli(args.res, args.width,
                                            args.height))
    proposer = (args.refine_loops if args.refine_loops in ("proximity",
                                                           "descriptor")
                else cfg.pose_graph.loop_proposer)
    cfg = dataclasses.replace(
        cfg, pose_graph=dataclasses.replace(
            cfg.pose_graph, loop_proposer=proposer,
            robust_loss=args.robust_loss),
        icp=dataclasses.replace(cfg.icp, metric=args.icp_metric))
    if args.synthetic:
        data = io.synthetic_dataset(n_steps=args.synthetic, seed=0)
    else:
        data = io.load_data(args.dataset, io.DATASET_NAMES, args.dataset_path)
        enc = sensors.Encoder.from_data(data["encoder"])
        imu = sensors.Imu.from_data(data["imu"])
        lid = sensors.Lidar.from_data(data["lidar"])
        sensors.synchronize_sensors(enc, imu, lid, base_sensor_index=0)
        data = {
            "encoder": {"counts": enc.counts_synced},
            "imu": {"angular_velocity": imu.gyro_synced},
            "lidar": {"ranges": lid.ranges_synced,
                      "range_min": lid.range_min,
                      "range_max": lid.range_max},
        }

    def on_device(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)

    counts = on_device(data["encoder"]["counts"])
    gyro = on_device(data["imu"]["angular_velocity"])
    ranges = on_device(data["lidar"]["ranges"])
    rmin = float(np.asarray(data["lidar"].get("range_min", 0.1)))
    rmax = float(np.asarray(data["lidar"].get("range_max", 30.0)))
    points, masks = scan_ops.scans_to_points(ranges, rmin, rmax, cfg.lidar)
    n = int(points.shape[0])
    K = online.default_ray_cells(cfg, rmax)

    start = 1
    window = 8192 if args.window is None else args.window
    if window <= 0:
        raise SystemExit(f"--window must be positive, got {window}")

    if args.resume:
        st = online.load_state(args.checkpoint, device=dev)
        ck_window = int(st.poses_hist.shape[0])
        if args.window is not None and args.window != ck_window:
            print(f"warning: --window {args.window} ignored on resume; "
                  f"the checkpoint's ring buffers fix the window at "
                  f"{ck_window}", file=sys.stderr)
        start = int(st.step) + 1
        print(f"resumed from {args.checkpoint} at step {start - 1}",
              file=sys.stderr)
        if start >= n:
            # resume indices are positions in the SAME stream
            print(f"stream exhausted: checkpoint is at step {start - 1} "
                  f"but the stream has only {n} steps; nothing to do "
                  "(pass a longer stream to continue this run)",
                  file=sys.stderr)
    else:
        st = online.init_state(points[0], masks[0], cfg, n_max=window, K=K,
                               device=dev)

    # track row i = pose of global step (start - 1 + i): a fresh run
    # covers step 0; a resumed run covers [resume step, n)
    track = [st.pose.cpu().numpy()]
    print(f"pose track starts at step {start - 1}", file=sys.stderr)
    t0 = time.time()
    for t in range(start, n):
        st = online.online_step(st, counts[t], gyro[t], points[t], masks[t],
                                cfg, K=K)
        track.append(st.pose.cpu().numpy())
        if args.refine_every and t % args.refine_every == 0:
            if args.refine_loops == "none":
                refined = online.refine(st, cfg)
            else:
                # the reference's per-step gates (main.py:94-101)
                max_d, max_y = odometry.max_step_gates(counts, gyro,
                                                       cfg.robot.dt)
                lo = max(0, t + 1 - int(st.poses_hist.shape[0]))
                refined = online.refine(
                    st, cfg, scans=points[lo:t + 1],
                    scan_masks=masks[lo:t + 1],
                    max_distance=float(max_d), max_yaw_deg=float(max_y),
                    descriptor_range=(rmin, rmax))
            print(f"step {t}: refined window of {refined.shape[0]} poses "
                  f"(start step {online.window_start(st)})",
                  file=sys.stderr)
            if args.checkpoint:
                online.save_state(args.checkpoint, st)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    streamed = max(0, n - start)
    rate = (f"{streamed / dt:.0f} Hz incl. host dispatch" if streamed
            else "idle")
    print(f"streamed {streamed} steps in {dt:.2f}s ({rate}); "
          f"final pose {st.pose.cpu().numpy()}", file=sys.stderr)

    if args.checkpoint:
        online.save_state(args.checkpoint, st)
        print(f"checkpoint -> {args.checkpoint}", file=sys.stderr)
    if args.poses_path:
        np.save(args.poses_path, np.asarray(track))
        print(f"pose track -> {args.poses_path}", file=sys.stderr)
    write_png(args.map_path, occupancy.render_logodds(st.logodds))
    print(f"causal map -> {args.map_path}", file=sys.stderr)
    if args.export_ros_map:
        from .utils import export

        pgm, yml = export.save_map_ros(st.logodds.cpu().numpy(), cfg.map,
                                       args.export_ros_map)
        print(f"ROS map_server map -> {pgm} + {yml}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
