"""CLI of the port's online (streaming) SLAM mode: the serving entry.

    python -m lidar_slam_tpu_torch.online_slam --synthetic 500 --device cuda
    python -m lidar_slam_tpu_torch.online_slam --dataset 20 --dataset_path data/
    python -m lidar_slam_tpu_torch.online_slam --synthetic 500 \
        --checkpoint ck.npz --resume
    python -m lidar_slam_tpu_torch.online_slam --synthetic 500 \
        --localize map.npy        # PF localization against a saved map
        # (map.npy from `python -m lidar_slam_tpu_torch --save_logodds`)

Counterpart of online_slam.py: it feeds one synchronized (encoder, gyro,
scan) tuple at a time through models/online.online_step, with optional
periodic sliding-window refinement and checkpoint/resume. It takes the same
flags with the same defaults and validation messages, plus --device, and
writes the same outputs: the causal map as a PNG (--map_path) and, with
--export_ros_map STEM, as a ROS map_server PGM + YAML, the pose track
including step 0 (--poses_path, .npy) and the checkpoint.
--refine_loops proximity|descriptor adds verified in-window revisit
closures to the refinement, --robust_loss huber|cauchy a robust kernel on
its loop factors, --icp_metric point_to_line PLICP scan matching.
--relocalize_on_loss gates the stream on the scan match's RMS (--loss_rms)
and recovers a lost pose by certified global relocalization against the
causal map. --localize MAP.npy streams particle-filter localization
(--particles, --x0) against a saved log-odds grid instead of SLAM;
--global_init first relocalizes scan 0 in that map and seeds the
particles around the fix.
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
                   help="detect tracking loss (scan-match RMS above "
                        "--loss_rms): the lost step coasts on odometry "
                        "without painting the map, then certified global "
                        "relocalization against the causal map re-seeds "
                        "the stream (kidnapped-robot recovery)")
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
                   help="localization-only serving mode: stream "
                        "particle-filter localization against this saved "
                        "log-odds grid (.npy, e.g. --save_logodds output), "
                        "built with the same --res/--width/--height")
    p.add_argument("--particles", type=int, default=256,
                   help="particle count for --localize")
    p.add_argument("--x0", type=str, default=None, metavar="X,Y,YAW",
                   help="initial pose for --localize (default 0,0,0)")
    p.add_argument("--global_init", action="store_true",
                   help="kidnapped-robot start for --localize: certified "
                        "global relocalization of the first scan fixes the "
                        "initial pose, and the particles seed as a cloud "
                        "around the fix")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    return p


def _run_localize(args, cfg, counts, gyro, points, masks, dev):
    """Localization-only serving: stream PF steps against a saved map."""
    import numpy as np
    import torch

    from .models.odometry import v_from_encoder
    from .models.particle_filter import PFConfig, init_pf_state, pf_step

    logodds = np.load(args.localize)
    if logodds.shape != (cfg.map.width, cfg.map.height):
        raise SystemExit(
            f"--localize: map {args.localize!r} has shape {logodds.shape} "
            f"but --res/--width/--height imply "
            f"({cfg.map.width}, {cfg.map.height}); pass the flags the map "
            "was built with")
    im = torch.as_tensor(logodds > 0, dtype=torch.float32, device=dev)

    pf_cfg = PFConfig(n_particles=args.particles)
    x0 = np.zeros(3, np.float32)
    if args.x0 is not None:
        vals = [float(v) for v in args.x0.split(",")]
        if len(vals) != 3:
            raise SystemExit(f"--x0 wants X,Y,YAW, got {args.x0!r}")
        x0 = np.asarray(vals, np.float32)

    init_particles = None
    if args.global_init:
        # kidnapped-robot start: the certified multi-resolution search fixes
        # scan 0's pose anywhere in the map (its top candidates polished,
        # the lowest normalized ICP error wins), then the particles seed as
        # a cloud around the fix; a blind uniform spread would need
        # O(map area x headings) particles to contain the true pose
        from .models.relocalization import RelocConfig, relocalize_refined
        reach = 0.5 * max(cfg.map.world_max_x - cfg.map.world_min_x,
                          cfg.map.world_max_y - cfg.map.world_min_y)
        t_r = time.time()
        grid_res, pose_fix, icp_err = relocalize_refined(
            torch.as_tensor(logodds, dtype=torch.float32, device=dev),
            cfg.map, points[0], masks[0], RelocConfig(search_radius=reach),
            n_candidates=4)
        x0 = pose_fix.cpu().numpy().astype(np.float32)
        print(f"global init: relocalized scan 0 to {np.round(x0, 3)} in "
              f"{time.time() - t_r:.1f}s (grid score "
              f"{float(grid_res.score):.0f}, certified="
              f"{bool(grid_res.certified)}, polish err "
              f"{float(icp_err):.2e})", file=sys.stderr)
        # the JAX CLI's numpy stream, so both seed the same cloud
        rng = np.random.default_rng(0)
        cloud = x0[None, :] + np.stack(
            [rng.normal(0, 2.0 * cfg.map.resolution, pf_cfg.n_particles),
             rng.normal(0, 2.0 * cfg.map.resolution, pf_cfg.n_particles),
             rng.normal(0, 0.05, pf_cfg.n_particles)], axis=-1)
        init_particles = cloud.astype(np.float32)

    v_all = v_from_encoder(counts)
    wyaw_all = gyro[:, -1]
    state = init_pf_state(pf_cfg, x0, init_particles=init_particles,
                          device=dev)
    n = int(points.shape[0])
    track = [torch.as_tensor(x0, device=dev)]
    t0 = time.time()
    for t in range(1, n):
        state, (est, neff, _) = pf_step(state, v_all[t], wyaw_all[t],
                                        points[t], masks[t], im, cfg.map,
                                        pf_cfg)
        track.append(est)
    track = torch.stack(track).cpu().numpy()
    dt = time.time() - t0
    neff = float(neff) if n > 1 else float(args.particles)
    print(f"localized {n - 1} steps in {dt:.2f}s "
          f"({(n - 1) / dt:.0f} Hz incl. host dispatch, "
          f"{args.particles} particles); final pose "
          f"{np.round(track[-1], 3)} (Neff {neff:.0f})", file=sys.stderr)
    if args.poses_path:
        np.save(args.poses_path, track)
        print(f"pose track -> {args.poses_path}", file=sys.stderr)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.localize:
        # fail fast on flags that only make sense for the SLAM stream:
        # ignoring them would misrepresent what ran
        for flag, name in ((args.resume, "--resume"),
                           (args.checkpoint, "--checkpoint"),
                           (args.refine_every, "--refine_every"),
                           (args.relocalize_on_loss, "--relocalize_on_loss")):
            if flag:
                raise SystemExit(f"--localize is localization-only; "
                                 f"{name} applies to the SLAM stream")
        if not os.path.exists(args.localize):
            raise SystemExit(f"--localize: map {args.localize!r} "
                             "does not exist")

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
    if args.relocalize_on_loss:
        cfg = dataclasses.replace(cfg, online=dataclasses.replace(
            cfg.online, loss_rms_thresh=args.loss_rms))
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

    if args.localize:
        _run_localize(args, cfg, counts, gyro, points, masks, dev)
        return 0

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
        if args.relocalize_on_loss and float(st.match_rms) > args.loss_rms:
            print(f"step {t}: tracking LOST (match RMS "
                  f"{float(st.match_rms):.2f} m > {args.loss_rms}); "
                  "relocalizing against the causal map...",
                  file=sys.stderr)
            st, grid_res, icp_err = online.relocalize_and_reseed(st, cfg,
                                                                 K=K)
            print(f"step {t}: relocalized to "
                  f"{np.round(st.pose.cpu().numpy(), 3)} "
                  f"(grid score {float(grid_res.score):.0f}, certified="
                  f"{bool(grid_res.certified)}, polish err "
                  f"{float(icp_err):.2e}); stream re-seeded",
                  file=sys.stderr)
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
