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
     versions) must agree.

The last three lines are the card's `name, power.limit`, a JSON object with
each kernel's launch count on the main path, its error against its plain
version and both times, and {"ok": true, "device": {...}}.
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
    from lidar_slam_tpu_torch.config import SlamConfig
    from lidar_slam_tpu_torch.kernels import build
    from lidar_slam_tpu_torch.kernels.nn import nn_argmin
    from lidar_slam_tpu_torch.kernels.raywalk import raywalk_build
    from lidar_slam_tpu_torch.models import occupancy, slam
    from lidar_slam_tpu_torch.ops import icp as icp_ops
    from lidar_slam_tpu_torch.ops import scan as scan_ops
    from lidar_slam_tpu_torch.ops.nn import gather_points, nearest_neighbors
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
    s, t, tm = pts3[1:65], pts3[:64], masks20[:64]
    idx_k, matched_k = nn_argmin(s, t, tm)
    idx_p = nearest_neighbors(s, t, tm)
    matched_p = gather_points(t, idx_p)
    torch.cuda.synchronize()
    if not torch.equal(matched_k, gather_points(t, idx_k)):
        fail("nn_argmin matched points differ from tgt[idx]")
    flips = float((idx_k != idx_p).float().mean())
    gap = float(((s - matched_k) ** 2).sum(-1).sub(
        ((s - matched_p) ** 2).sum(-1)).abs().max())
    nn_ms = cuda_ms(lambda: nn_argmin(s, t, tm), 50)
    nn_plain_ms = cuda_ms(
        lambda: gather_points(t, nearest_neighbors(s, t, tm)), 50)
    print(f"[3] nn_argmin vs plain, 64 x 1081 x 1081: index flips "
          f"{flips:.5f}, max chosen-distance gap {gap:.3e}; kernel "
          f"{nn_ms:.4f} ms, plain {nn_plain_ms:.4f} ms", flush=True)
    if flips > NN_MAX_FLIP_FRACTION or gap > NN_MAX_GAP:
        fail(f"nn_argmin disagrees with its plain version (flips {flips}, "
             f"gap {gap})")

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
    # index_put_(accumulate=True) sums a cell's adds in another order than
    # ray order, so it differs from both in the last bit of a few cells.
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

    print(card)
    print(json.dumps({"kernels": [
        {"name": "nn_argmin", "route": "cuda",
         "source": "lidar_slam_tpu_torch/csrc/nn.cu",
         "replaces": "lidar_slam_tpu/ops/pallas_nn.py:64",
         "launches": launches["nn_argmin"], "max_abs_err": gap,
         "ms": nn_ms, "plain_ms": nn_plain_ms},
        {"name": "raywalk_build", "route": "cuda",
         "source": "lidar_slam_tpu_torch/csrc/raywalk.cu",
         "replaces": "lidar_slam_tpu/ops/raywalk.py:608",
         "launches": launches["raywalk_build"],
         "max_abs_err": max(diff, diff_main),
         "ms": rw_ms, "plain_ms": rw_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
