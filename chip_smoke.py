#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU and nvcc. Phases,
one printed line each (the script stops with a nonzero exit code at the
first failure and catches nothing):

  1. device check and the card's `name, power.limit` (nvidia-smi);
  2. build of the CUDA kernels from lidar_slam_tpu_torch/csrc;
  3. nn_argmin kernel against its plain version on one real ICP chunk
     (64 consecutive scan pairs of the seed-20 dataset);
  4. raywalk_build kernel against its plain version (the scatter path, run
     on CPU copies of the same ray end cells) on 32 scans: bit-exact;
  5. the main path, run_slam(mode="gtsam", device="cuda"), on the
     dataset-20-scale synthetic log (4,956 scans x 1,081 rays, seed 21):
     once to warm up, once timed with the kernels' launch counters reset
     just before it; stage seconds, ICP/loop/LM counts, map cell counts
     and launch counts; then that run's map (built by raywalk_build)
     against the scatter path on CPU copies of its ray end cells,
     bit-exact, and both map engines timed on the GPU;
  6. the same pipeline on a small log on the GPU and on the CPU (plain
     versions) must agree;
  7. raywalk_scan kernel against its plain version at the online path's
     shapes (1,081 rays, K = 608, 1201 x 1201): the first 200 scans of the
     seed-21 log replayed at their odometry poses, clipped, on a GPU grid
     and on a CPU copy, and one unclipped scan_delta: bit-exact; per-scan
     times of the kernel and the plain scatter on the GPU; nn_argmin at
     the online path's B = 1;
  8. the online (serving) path at dataset-20 width: init_state and
     online_step over the whole 4,956-step log (n_max 8,192, refine with
     gated fixed loops every 1,000 steps), after a 50-step warm-up, with
     the kernels' launch counters reset just before it; steps/s, per-step
     p50/p99 ms, refine seconds and launch counts; the causal map against
     raywalk_build over the stream's own poses (bit-exact) and the
     relative poses against poses_from_scan_matching;
  9. a small stream on the GPU and on the CPU must agree, and a checkpoint
     saved mid-stream and resumed on the GPU must continue bit for bit.

The last three lines are the card's `name, power.limit`, a JSON object with
each kernel's launch count on the main paths ([5] and [8]), its error
against its plain version and both times, and {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

NN_MAX_FLIP_FRACTION = 0.01  # near-tie index flips allowed (bench.py gate)
NN_MAX_GAP = 1e-3  # max chosen-neighbour squared-distance gap (bench.py gate)
SMALL_POSE_TOL = 1e-3  # GPU vs CPU poses on the small log (m, rad)
SMALL_GRID_TOL = 0.01  # fraction of grid_map cells allowed to differ
REL_TOL = 2e-4  # online vs offline relative poses (tests/test_online.py:47)
REL_MAX_SHARE = 0.01  # share of steps allowed past REL_TOL (NN near-ties)
ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the current stream (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nn_check(s, t, tm, reps: int):
    """nn_argmin against its plain version on (s, t, tm): index-flip
    share, max chosen-distance gap, kernel ms and plain ms."""
    from lidar_slam_tpu_torch.kernels.nn import nn_argmin
    from lidar_slam_tpu_torch.ops.nn import gather_points, nearest_neighbors

    idx_k, matched_k = nn_argmin(s, t, tm)
    idx_p = nearest_neighbors(s, t, tm)
    matched_p = gather_points(t, idx_p)
    torch.cuda.synchronize()
    if not torch.equal(matched_k, gather_points(t, idx_k)):
        fail("nn_argmin matched points differ from tgt[idx]")
    flips = float((idx_k != idx_p).float().mean())
    gap = float(((s - matched_k) ** 2).sum(-1).sub(
        ((s - matched_p) ** 2).sum(-1)).abs().max())
    ms = cuda_ms(lambda: nn_argmin(s, t, tm), reps)
    plain_ms = cuda_ms(
        lambda: gather_points(t, nearest_neighbors(s, t, tm)), reps)
    if flips > NN_MAX_FLIP_FRACTION or gap > NN_MAX_GAP:
        fail(f"nn_argmin disagrees with its plain version (flips {flips}, "
             f"gap {gap})")
    return flips, gap, ms, plain_ms


def synced(data, sensors):
    enc = sensors.Encoder.from_data(data["encoder"])
    imu = sensors.Imu.from_data(data["imu"])
    lid = sensors.Lidar.from_data(data["lidar"])
    sensors.synchronize_sensors(enc, imu, lid, base_sensor_index=0)
    return (enc.counts_synced, imu.gyro_synced, lid.ranges_synced,
            float(lid.range_min), float(lid.range_max))


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", flush=True)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"[1] device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)",
          flush=True)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lidar_slam_tpu_torch import sensors
    from lidar_slam_tpu_torch.config import MapConfig, SlamConfig
    from lidar_slam_tpu_torch.kernels import build
    from lidar_slam_tpu_torch.kernels.nn import nn_argmin
    from lidar_slam_tpu_torch.kernels.raywalk import raywalk_build, raywalk_scan
    from lidar_slam_tpu_torch.models import (occupancy, odometry, online,
                                             scan_matching, slam)
    from lidar_slam_tpu_torch.ops import icp as icp_ops
    from lidar_slam_tpu_torch.ops import scan as scan_ops
    from lidar_slam_tpu_torch.ops.raywalk import scan_delta_raywalk
    from lidar_slam_tpu_torch.utils import io

    dev = torch.device("cuda")
    cfg = SlamConfig()

    # 2. build
    lib_path, build_s = build.build()
    build.library()
    print(f"[2] kernels built in {build_s:.2f} s -> "
          f"{os.path.relpath(lib_path)}", flush=True)

    # 3. nn_argmin vs plain on one real chunk
    d20 = io.synthetic_dataset(n_steps=4956, n_rays=1081, seed=20)
    ranges20 = torch.as_tensor(d20["lidar"]["ranges"], dtype=torch.float32,
                               device=dev)
    pts20, masks20 = scan_ops.scans_to_points(ranges20, 0.1, 30.0, cfg.lidar)
    pts3 = icp_ops.lift_to_3d(pts20)
    flips, gap, nn_ms, nn_plain_ms = nn_check(pts3[1:65], pts3[:64],
                                              masks20[:64], 50)
    print(f"[3] nn_argmin vs plain, 64 x 1081 x 1081: index flips "
          f"{flips:.5f}, max chosen-distance gap {gap:.3e}; kernel "
          f"{nn_ms:.4f} ms, plain {nn_plain_ms:.4f} ms", flush=True)

    # 4. raywalk_build vs plain on 32 scans
    K20 = occupancy.adaptive_ray_cells(pts20, masks20, cfg.map, 30.0)
    rng = np.random.default_rng(7)
    poses32 = torch.as_tensor(rng.normal(0, 2.0, (32, 3)).cumsum(0) * 0.01,
                              dtype=torch.float32, device=dev)
    ends32 = occupancy.ray_ends(poses32, pts20[:32], cfg.map)
    g_k = raywalk_build(ends32, masks20[:32], cfg.map, K20)
    g_p = occupancy.build_logodds_scatter(ends32.cpu(), masks20[:32].cpu(),
                                          cfg.map, K20)
    diff = float((g_k.cpu() - g_p).abs().max())
    same_final = torch.equal(occupancy.finalize_grid(g_k).cpu(),
                             occupancy.finalize_grid(g_p))
    print(f"[4] raywalk_build vs plain (CPU scatter), 32 scans, K={K20}: "
          f"max |diff| {diff}, finalize_grid equal {same_final}, "
          f"nonzero cells {int((g_p != 0).sum())}", flush=True)
    if diff != 0.0 or not same_final or int((g_p != 0).sum()) < 1000:
        fail("raywalk_build disagrees with the scatter path")

    # 5. the main path at dataset-20 scale
    args = synced(io.synthetic_dataset(n_steps=4956, n_rays=1081, seed=21),
                  sensors)
    slam.run_slam(*args, mode="gtsam", cfg=cfg, device=dev)  # warm-up
    torch.cuda.synchronize()
    nn_argmin.launches = 0
    raywalk_build.launches = 0
    t0 = time.perf_counter()
    res = slam.run_slam(*args, mode="gtsam", cfg=cfg, device=dev)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {"nn_argmin": nn_argmin.launches,
                "raywalk_build": raywalk_build.launches}
    st = res.stage_seconds
    print("[5] main path gtsam, 4956 scans x 1081 rays: total "
          f"{total:.3f} s; " + ", ".join(f"{k} {v:.3f} s"
                                         for k, v in st.items()), flush=True)
    occ = int((res.logodds > 0).sum())
    free = int((res.logodds < 0).sum())
    print(f"[5] ICP iterations mean {res.scan_matching_iters.mean():.2f} "
          f"max {int(res.scan_matching_iters.max())}; loops accepted "
          f"{res.n_loop_closures}/{res.loop_accept.size}; LM iterations "
          f"{res.lm_iterations}; K {res.ray_cells}; occupied cells {occ}, "
          f"free cells {free}; launches {launches}", flush=True)
    if min(launches.values()) == 0:
        fail(f"a kernel was not launched on the main path: {launches}")
    if res.poses.shape != (4956, 3) or not np.isfinite(res.poses).all():
        fail("main path poses are not finite (4956, 3)")
    if occ == 0 or free == 0:
        fail("main path map is empty")

    # the main path's own map (built by the ray-walk kernel) against the
    # plain version on CPU copies of the same ray end cells: bit-exact.
    # The scatter path on the GPU is timed but not compared: CUDA's
    # index_add_ sums a cell's adds in another order than ray order, so it
    # differs from both in the last bit of a few cells.
    poses_main = torch.as_tensor(res.poses, device=dev)
    pts21, masks21 = scan_ops.scans_to_points(
        torch.as_tensor(args[2], dtype=torch.float32, device=dev), 0.1, 30.0,
        cfg.lidar)
    ends_main = occupancy.ray_ends(poses_main, pts21, cfg.map)
    K = res.ray_cells
    g_plain = occupancy.build_logodds_scatter(ends_main.cpu(), masks21.cpu(),
                                              cfg.map, K)
    diff_main = float((torch.from_numpy(res.logodds) - g_plain).abs().max())
    same_grid = np.array_equal(res.grid_map,
                               occupancy.finalize_grid(g_plain).numpy())
    rw_ms = cuda_ms(lambda: raywalk_build(ends_main, masks21, cfg.map, K), 3)
    rw_plain_ms = cuda_ms(lambda: occupancy.build_logodds_scatter(
        ends_main, masks21, cfg.map, K), 1)
    print(f"[5] main-path map (4956 scans, K={K}) vs plain (CPU scatter): "
          f"max |diff| {diff_main}, finalize_grid equal {same_grid}; "
          f"raywalk_build {rw_ms:.3f} ms, plain scatter path on the GPU "
          f"{rw_plain_ms:.3f} ms", flush=True)
    if diff_main != 0.0 or not same_grid:
        fail("the main path's map disagrees with the scatter path")

    # 6. small log: GPU (kernels) against CPU (plain versions)
    small = synced(io.synthetic_dataset(n_steps=120, n_rays=361, seed=3),
                   sensors)
    r_gpu = slam.run_slam(*small, mode="gtsam", cfg=cfg, device=dev)
    r_cpu = slam.run_slam(*small, mode="gtsam", cfg=cfg, device="cpu")
    pose_diff = float(np.abs(r_gpu.poses - r_cpu.poses).max())
    grid_diff = float((r_gpu.grid_map != r_cpu.grid_map).mean())
    print(f"[6] small log (120 x 361) GPU vs CPU: max pose diff "
          f"{pose_diff:.3e}, grid_map cells differing {grid_diff:.5f}",
          flush=True)
    if pose_diff > SMALL_POSE_TOL or grid_diff > SMALL_GRID_TOL:
        fail("GPU and CPU pipelines disagree on the small log")

    # 7. raywalk_scan vs plain at the online path's shapes, and K4 at B = 1
    cfg_on = SlamConfig(map=MapConfig.from_cli(0.05, 60, 60))
    m_on = cfg_on.map
    K_on = online.default_ray_cells(cfg_on, 30.0)
    clip = m_on.logodds_clip
    counts21, gyro21 = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                        for a in args[:2])
    podo = odometry.poses_from_odometry(counts21, gyro21, dt=cfg.robot.dt)
    ends200 = occupancy.ray_ends(podo[:200], pts21[:200], m_on)
    e_cpu, mk_cpu = ends200.cpu(), masks21[:200].cpu()
    g_k = torch.zeros((m_on.width, m_on.height), device=dev)
    g_p = torch.zeros((m_on.width, m_on.height))
    for i in range(200):
        raywalk_scan(ends200[i], masks21[i], m_on, K_on, g_k, clip)
        raywalk_scan(e_cpu[i], mk_cpu[i], m_on, K_on, g_p, clip)
    diff_scan = float((g_k.cpu() - g_p).abs().max())
    delta_k = scan_delta_raywalk(podo[200], pts21[200], masks21[200], m_on,
                                 K_on)
    e1 = occupancy.ray_ends(podo[200], pts21[200], m_on)
    delta_p = raywalk_scan(e1.cpu(), masks21[200].cpu(), m_on, K_on,
                           torch.zeros_like(g_p), None)
    diff_delta = float((delta_k.cpu() - delta_p).abs().max())
    print(f"[7] raywalk_scan vs plain (CPU), 200 scans x 1081 rays, K={K_on},"
          f" {m_on.width}x{m_on.height}, clipped: max |diff| {diff_scan}, "
          f"nonzero cells {int((g_p != 0).sum())}; one unclipped "
          f"scan_delta: max |diff| {diff_delta}, min {float(delta_p.min())}",
          flush=True)
    if diff_scan != 0.0 or diff_delta != 0.0:
        fail("raywalk_scan disagrees with its plain version")
    if int((g_p != 0).sum()) < 1000 or float(delta_p.min()) >= -clip:
        fail("the raywalk_scan check painted too little (or clipped the "
             "delta)")
    e_t, m_t = ends200[100], masks21[100]
    g_t, g_t2 = g_k.clone(), g_k.clone()

    def scan_kernel():
        raywalk_scan(e_t, m_t, m_on, K_on, g_t, clip)

    def scan_plain():
        occupancy.scatter_scan_(g_t2, e_t, m_t, m_on, K_on).clamp_(-clip,
                                                                   clip)

    t_plain = [cuda_ms(scan_plain, 100)]
    t_k = [cuda_ms(scan_kernel, 100), cuda_ms(scan_kernel, 100)]
    t_plain.append(cuda_ms(scan_plain, 100))
    scan_ms, scan_plain_ms = sum(t_k) / 2, sum(t_plain) / 2
    delta_ms = cuda_ms(lambda: scan_delta_raywalk(podo[200], pts21[200],
                                                  masks21[200], m_on, K_on),
                       100)
    pts3_21 = icp_ops.lift_to_3d(pts21)
    flips1, gap1, nn1_ms, nn1_plain_ms = nn_check(
        pts3_21[101:102], pts3_21[100:101], masks21[100:101], 200)
    print(f"[7] per scan (CUDA events, 100 launches, kernel-plain turns "
          f"{t_plain[0]:.4f}/{t_k[0]:.4f}/{t_k[1]:.4f}/{t_plain[1]:.4f} ms):"
          f" raywalk_scan {scan_ms:.4f} ms, plain scatter + clamp on the GPU"
          f" {scan_plain_ms:.4f} ms; scan_delta (zero grid + unclipped walk)"
          f" {delta_ms:.4f} ms; nn_argmin B=1 1x1081x1081: flips "
          f"{flips1:.5f}, gap {gap1:.3e}, kernel {nn1_ms:.4f} ms, plain "
          f"{nn1_plain_ms:.4f} ms", flush=True)

    # 8. the online (serving) path at dataset-20 width
    max_d, max_y = (float(v) for v in odometry.max_step_gates(
        counts21, gyro21, cfg_on.robot.dt))

    def stream(n_steps):
        st = online.init_state(pts21[0], masks21[0], cfg_on, n_max=8192,
                               K=K_on, device=dev)
        step_s, refine_s, refined = [], [], None
        for t in range(1, n_steps):
            t0 = time.perf_counter()
            st = online.online_step(st, counts21[t], gyro21[t], pts21[t],
                                    masks21[t], cfg_on, K=K_on)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            if t % 1000 == 0:
                t0 = time.perf_counter()
                refined = online.refine(
                    st, cfg_on, scans=pts21[:t + 1],
                    scan_masks=masks21[:t + 1], max_distance=max_d,
                    max_yaw_deg=max_y)
                refine_s.append(time.perf_counter() - t0)
                if not np.isfinite(refined).all():
                    fail(f"refine at step {t} returned non-finite poses")
        return st, np.asarray(step_s), refine_s, refined

    stream(50)  # warm-up
    n_on = pts21.shape[0]
    nn_argmin.launches = raywalk_build.launches = raywalk_scan.launches = 0
    t0 = time.perf_counter()
    st, step_s, refine_s, refined = stream(n_on)
    wall = time.perf_counter() - t0
    launches_on = {"nn_argmin": nn_argmin.launches,
                   "raywalk_build": raywalk_build.launches,
                   "raywalk_scan": raywalk_scan.launches}
    p50, p99 = (float(np.percentile(step_s, q)) * 1e3 for q in (50, 99))
    print(f"[8] online path, {n_on} steps x 1081 rays, K={K_on}, n_max 8192:"
          f" {(n_on - 1) / step_s.sum():.1f} steps/s over the steps "
          f"({step_s.sum():.3f} s), per-step p50 {p50:.3f} ms, p99 "
          f"{p99:.3f} ms, max {step_s.max() * 1e3:.3f} ms; refine "
          f"{len(refine_s)} x (" + ", ".join(f"{r:.3f}" for r in refine_s)
          + f") s, last window {refined.shape[0]} poses; wall {wall:.3f} s;"
          f" launches {launches_on}", flush=True)
    painted = n_on  # init_state + every step: the loss gate is off
    if launches_on["raywalk_scan"] != painted:
        fail(f"raywalk_scan launched {launches_on['raywalk_scan']} times, "
             f"expected {painted}")
    if launches_on["nn_argmin"] == 0:
        fail("nn_argmin was not launched on the online path")
    track = st.poses_hist[:n_on]
    if not bool(torch.isfinite(track).all()):
        fail("online poses are not finite")
    g_k1 = raywalk_build(occupancy.ray_ends(track, pts21, m_on), masks21,
                         m_on, K_on)
    diff_k1 = float((st.logodds - g_k1).abs().max())
    sm = scan_matching.poses_from_scan_matching(podo, pts21, masks21,
                                                cfg_on.icp)
    drel = (st.rel_hist[1:n_on] - sm.relative_poses).abs().amax(dim=(1, 2))
    rel_max = float(drel.max())
    rel_share = float((drel > REL_TOL).float().mean())
    print(f"[8] causal map vs raywalk_build over the stream's poses: max "
          f"|diff| {diff_k1}, nonzero cells {int((g_k1 != 0).sum())}; "
          f"relative poses vs poses_from_scan_matching: max |diff| "
          f"{rel_max:.3e}, share of steps above {REL_TOL} {rel_share:.5f}",
          flush=True)
    if diff_k1 != 0.0:
        fail("the online causal map disagrees with raywalk_build")
    if rel_max > REL_TOL and rel_share > REL_MAX_SHARE:
        fail("the online relative poses disagree with scan matching")

    # 9. small stream: GPU against CPU, and a mid-stream checkpoint resumed
    small_log = synced(io.synthetic_dataset(n_steps=120, n_rays=361, seed=3),
                       sensors)
    ck_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(ck_dir, exist_ok=True)
    ck_path = os.path.join(ck_dir, "online_ck.npz")

    def small_stream(device, save_at=None):
        c, g, r = (torch.as_tensor(a, dtype=torch.float32, device=device)
                   for a in small_log[:3])
        pts, msk = scan_ops.scans_to_points(r, small_log[3], small_log[4],
                                            cfg_on.lidar)
        st = online.init_state(pts[0], msk[0], cfg_on, n_max=8192, K=K_on,
                               device=device)
        for t in range(1, pts.shape[0]):
            st = online.online_step(st, c[t], g[t], pts[t], msk[t], cfg_on,
                                    K=K_on)
            if t == save_at:
                online.save_state(ck_path, st)
        return st, (c, g, pts, msk)

    st_g, (c, g, pts, msk) = small_stream(dev, save_at=60)
    st_c, _ = small_stream("cpu")
    st_r = online.load_state(ck_path, device=dev)
    for t in range(61, pts.shape[0]):
        st_r = online.online_step(st_r, c[t], g[t], pts[t], msk[t], cfg_on,
                                  K=K_on)
    n_small = pts.shape[0]
    pose_diff_s = float((st_g.poses_hist[:n_small].cpu()
                         - st_c.poses_hist[:n_small]).abs().max())
    grid_diff_s = float((occupancy.finalize_grid(st_g.logodds).cpu()
                         != occupancy.finalize_grid(st_c.logodds)).float()
                        .mean())
    same_resume = all(torch.equal(a, b) for a, b in zip(st_r, st_g))
    print(f"[9] small stream ({n_small} x 361) GPU vs CPU: max pose diff "
          f"{pose_diff_s:.3e}, grid_map cells differing {grid_diff_s:.5f};"
          f" resumed at step 60 from a checkpoint: bit-equal {same_resume}",
          flush=True)
    if pose_diff_s > SMALL_POSE_TOL or grid_diff_s > SMALL_GRID_TOL:
        fail("GPU and CPU online streams disagree on the small log")
    if not same_resume:
        fail("the resumed GPU stream differs from the uninterrupted one")

    print(card)
    # launches: the main paths' runs, gtsam [5] plus online [8]
    print(json.dumps({"kernels": [
        {"name": "nn_argmin", "route": "cuda",
         "source": "lidar_slam_tpu_torch/csrc/nn.cu",
         "replaces": "lidar_slam_tpu/ops/pallas_nn.py:64",
         "launches": launches["nn_argmin"] + launches_on["nn_argmin"],
         "max_abs_err": max(gap, gap1), "ms": nn_ms,
         "plain_ms": nn_plain_ms},
        {"name": "raywalk_build", "route": "cuda",
         "source": "lidar_slam_tpu_torch/csrc/raywalk.cu",
         "replaces": "lidar_slam_tpu/ops/raywalk.py:608",
         "launches": launches["raywalk_build"]
         + launches_on["raywalk_build"],
         "max_abs_err": max(diff, diff_main, diff_k1),
         "ms": rw_ms, "plain_ms": rw_plain_ms},
        {"name": "raywalk_scan", "route": "cuda",
         "source": "lidar_slam_tpu_torch/csrc/raywalk.cu",
         "replaces": "lidar_slam_tpu/ops/raywalk.py:461",
         "launches": launches_on["raywalk_scan"],
         "max_abs_err": max(diff_scan, diff_delta, diff_k1),
         "ms": scan_ms, "plain_ms": scan_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
