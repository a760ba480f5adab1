#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA GPU and nvcc. Phases,
one printed line each (the script stops with a nonzero exit code at the
first failure and catches nothing):

  1. device check and the card's `name, power.limit` (nvidia-smi);
  2. build of the CUDA kernels from lidar_slam_tpu_torch/csrc;
  3. nn_argmin kernel on one real ICP chunk (64 consecutive scan pairs
     of the seed-20 dataset): indices equal to nn_argmin_rounded (its
     arithmetic op by op in PyTorch) and matched points bit-equal, and
     within the index-flip gate of its plain version;
  4. raywalk_build kernel against its plain version (the scatter path, run
     on CPU copies of the same ray end cells) on 32 scans: bit-exact; its
     binning kernel's per-owner lists equal to the plain lists;
  5. the main path, run_slam(mode="gtsam", device="cuda"), on the
     dataset-20-scale synthetic log (4,956 scans x 1,081 rays, seed 21):
     once to warm up, once timed with the kernels' launch counters reset
     just before it; stage seconds, ICP/loop/LM counts, map cell counts
     and launch counts; then that run's map (built by raywalk_build)
     against the scatter path on CPU copies of its ray end cells,
     bit-exact, and both map engines timed on the GPU; the binning
     kernel's per-owner lists of that run's rays equal, entry for entry, to
     the plain lists (raywalk_bins_plain, plain PyTorch on the card);
     raywalk_build's owner side, list entries, hottest owner's crossings
     and binning time;
  6. the same pipeline on a small log on the GPU and on the CPU (plain
     versions) must agree; the gtsam CLI on the card (60 synthetic steps)
     with --save_logodds, then --load_poses on its optimized poses, must
     write the same grid bit for bit, and that map must agree with
     run_slam on the CPU on the same dataset, as the small log must;
  7. raywalk_scan kernel against its plain version at the online path's
     shapes (1,081 rays, K = 608, 1201 x 1201): the first 200 scans of the
     seed-21 log replayed at their odometry poses, clipped, on a GPU grid
     and on a CPU copy, and one unclipped scan_delta: bit-exact; per-scan
     times of the kernel and the plain scatter on the GPU; nn_argmin at
     the online path's B = 1, gated as in [3];
  8. the online (serving) path at dataset-20 width: init_state and
     online_step over the whole 4,956-step log (n_max 8,192, refine with
     gated fixed loops every 1,000 steps), after a 50-step warm-up, with
     the kernels' launch counters reset just before it; steps/s, per-step
     p50/p99 ms, refine seconds and launch counts; the causal map against
     raywalk_build over the stream's own poses (bit-exact) and the
     relative poses against poses_from_scan_matching;
  9. a small stream on the GPU and on the CPU must agree, and a checkpoint
     saved mid-stream and resumed on the GPU must continue bit for bit;
 10. the probe kernels P1-P9 (csrc/probes.cu) against their plain versions
     on CPU copies, bit-exact, at the JAX probe tools' sizes (P9's six
     modes at the tool's 16,384-pair word table, two repetitions), P7 also
     with one cell taking an eighth of its 657,408 adds, P8 also with all
     82,432 segments on one tile; timed in turns with the library call
     where one computes the same function (P9 at a reduced 64 pairs x 2
     repetitions, as its plain version loops in Python, with the timed
     case's kernel output held bit for bit against its plain version's on
     the card), P2-P4 also with 65,536 entries, 7 in 8 on one tile (P2
     takes their rows alone), and P1 and P5 also at 4,096 entries whose
     float32 sum depends on the order; then,
     with the launch counters reset, the port's three probe tools
     (lidar_slam_tpu_torch/tools: pallas_probe, scatter_microbench,
     vpu_probe) at the JAX tools' sizes and counts;
 11. device time a launch from torch.profiler (self CUDA time over the
     launches) beside the CUDA-event time, for raywalk_scan over 100
     clipped scans and nn_argmin over 200 launches at B = 1 and 50 at 64
     pairs; raywalk_build's binning and walk kernels over three main-path
     builds, and the walk's ns a crossing of the hottest owner; P1-P6 over
     100 launches each on the JAX tool's inputs (P1-P5 also at [10]'s
     second cases); the host's side of a P1-P6 call and of nn_argmin at
     B = 1 (tools/host_split: the host clock of the wrapper, of its
     torch.empty and of its C entry point alone, and the rest, its
     Python) beside sum, index_add_ and torch.ones, and torch.profiler's
     CPU events of P5 and P6 beside sum and torch.ones; P7's five kernels
     and P8's one over 20 calls at the tools' sizes; P9's kernel, by name,
     at [10]'s timed case and at the tool's full mode (16,384 pairs x 8
     repetitions); and 100 online steps of a fresh stream (after 20
     unprofiled ones): device time and kernel launches a step, and the
     share of raywalk_scan and nn_argmin (after every timing of [1]-[10],
     so the profiler cannot slow them; [12] and [13] run outside it);
 12. the filtered main path, run_slam(mode="gtsam", filter_lidar=True), on
     [5]'s log (5.79 G DBSCAN point pairs), warmed up and timed with K1's
     and K4's launch counters reset just before it: stage seconds with the
     filter's; DBSCAN masks on the card equal to the CPU's on 256 scans,
     the statistical filter's threshold within 1e-6 of the CPU's and its
     masks equal outside that band (the points inside it counted), poses
     finite, and its map against the plain scatter on CPU copies of the
     kept rays, bit-exact;
 13. the texture of 2,407 RGB-D frames of 480 x 640 (bench.py's
     synthetic frames and poses) on the 1201 x 1201 map, projector
     "device": seconds a frame; the cells and colors painted by the first
     64 frames on the card equal to the CPU's, bit for bit;
 14. revisit loop closures on the card (revisit_phase): (a) the two-lap
     revisit world (4,956 x 1,081) with the descriptor proposer and the
     Cauchy kernel against the fixed proposer (a revisit kept, ATE below
     the fixed run's, the map bit-exact against the plain scatter); (b)
     the reversed-lap world (4,956 steps) with estimate-seeded proximity
     within 2 m and TrICP 0.55 against fixed (a closure kept, ATE below
     fixed's); (c) PLICP scan matching on [5]'s log; (d) [5]'s fixed
     graph by the banded, direct and CG solvers, direct held to banded in
     float64 (float32 printed); (e) a small revisit log on the card and
     on the CPU (the same kept pairs, poses within 1e-3). Each run prints
     its proposals, kept closures, LM iterations, ATE, stage seconds and
     K4 and K1 launches.

The last three lines are the card's `name, power.limit`, a JSON object with
each kernel's launch count on its path ([5] and [8] for K1, K2 and K4, and
[12]'s and [14]'s revisit runs apart for K1 and K4; the tools' run in [10]
for P1-P9), its error against its plain version, its,
the plain version's and the library call's times, and its bound (the
larger of its bytes over 3.35 TB/s and its operations over 67 TFLOP/s,
the H100's published HBM and FP32 rates; nn_argmin also at B = 1, and
every kernel with its profiler device time; P1-P6 and nn_argmin at B = 1
with their host split; P9 also with the probe tool's slopes), and
{"ok": true, "device": ...}.
"""

import json
import os
import subprocess
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

NN_MAX_FLIP_FRACTION = 0.01  # near-tie index flips allowed (bench.py gate)
NN_MAX_GAP = 1e-3  # max chosen-neighbour squared-distance gap (bench.py gate)
SMALL_POSE_TOL = 1e-3  # GPU vs CPU poses on the small log (m, rad)
SMALL_GRID_TOL = 0.01  # fraction of grid_map cells allowed to differ
REL_TOL = 2e-4  # online vs offline relative poses (tests/test_online.py:47)
REL_MAX_SHARE = 0.01  # share of steps allowed past REL_TOL (NN near-ties)
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3, published
FP32_OPS_S = 67e12  # H100 SXM FP32 outside the tensor cores, published
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


def bound(nbytes: float, ops: float):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move nbytes and do ops FP32 operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def turns(plain, kernel, library, reps: int, plain_reps: int | None = None):
    """Kernel, plain and library ms (library None without one), timed in
    turns plain, kernel, library, library, kernel, plain; each the mean of
    its two turns."""
    plain_reps = plain_reps or reps
    t_p = [cuda_ms(plain, plain_reps)]
    t_k = [cuda_ms(kernel, reps)]
    t_l = [cuda_ms(library, reps) for _ in range(2)] if library else [None]
    t_k.append(cuda_ms(kernel, reps))
    t_p.append(cuda_ms(plain, plain_reps))
    return (sum(t_k) / 2, sum(t_p) / 2,
            None if library is None else sum(t_l) / 2)


def device_kernels(fn, reps: int) -> dict:
    """{kernel name: (device us, launches)} of the device kernels that reps
    calls of fn ran, from torch.profiler (self CUDA time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {ev.key: (getattr(ev, "self_device_time_total", None)
                     or ev.self_cuda_time_total, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA}


def device_ms(fn, reps: int, kernel: str):
    """Device ms a launch of the kernels whose name holds `kernel` over
    reps calls of fn (after one unprofiled call); None if the trace shows
    none in three profiled runs (on an H100 one trace in a run of this
    script came back without nn_argmin's events at 64 pairs)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        hits = [v for k, v in device_kernels(fn, reps).items() if kernel in k]
        us, count = sum(v[0] for v in hits), sum(v[1] for v in hits)
        if count and us > 0:
            return us / count / 1e3
    return None


def pass_ms(fn, reps: int, names) -> dict:
    """{name: device ms a call of fn} of the device kernels whose name
    holds each of `names`, over reps calls (after one unprofiled call);
    None for a name the trace shows no event of in three profiled runs."""
    fn()
    torch.cuda.synchronize()
    out = dict.fromkeys(names)
    for _ in range(3):
        kern = device_kernels(fn, reps)
        for name in names:
            us = sum(v[0] for k, v in kern.items() if name in k)
            if out[name] is None and us > 0:
                out[name] = us / reps / 1e3
        if None not in out.values():
            break
    return out


def cpu_events(fn, reps: int) -> dict:
    """{CPU event: self CPU us a call} of reps calls of fn under
    torch.profiler (CUDA runtime calls included; the profiler slows
    them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {ev.key: ev.self_cpu_time_total / reps
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CPU and ev.self_cpu_time_total}


def nn_check(s, t, tm, reps: int):
    """nn_argmin on (s, t, tm): against nn_argmin_rounded exactly (fails
    on any index or matched-bit difference), against its plain version
    within the index-flip gate; index-flip share, max chosen-distance
    gap, kernel, plain and library ms (the library: torch.cdist + argmin
    with the masked targets moved far out of range), and the bound."""
    from lidar_slam_tpu_torch.kernels.nn import nn_argmin, nn_argmin_rounded
    from lidar_slam_tpu_torch.ops.nn import gather_points, nearest_neighbors

    idx_k, matched_k = nn_argmin(s, t, tm)
    idx_r, matched_r = nn_argmin_rounded(s, t, tm)
    idx_p = nearest_neighbors(s, t, tm)
    matched_p = gather_points(t, idx_p)
    torch.cuda.synchronize()
    mismatches = int((idx_k != idx_r).sum())
    if mismatches or not torch.equal(matched_k.view(torch.int32),
                                     matched_r.view(torch.int32)):
        fail(f"nn_argmin differs from nn_argmin_rounded: {mismatches} "
             f"indices")
    flips = float((idx_k != idx_p).float().mean())
    gap = float(((s - matched_k) ** 2).sum(-1).sub(
        ((s - matched_p) ** 2).sum(-1)).abs().max())
    far = torch.where(tm[..., None], t, torch.full_like(t, 1e6))
    ms, plain_ms, lib_ms = turns(
        lambda: gather_points(t, nearest_neighbors(s, t, tm)),
        lambda: nn_argmin(s, t, tm),
        lambda: torch.cdist(s, far).argmin(-1), reps)
    if flips > NN_MAX_FLIP_FRACTION or gap > NN_MAX_GAP:
        fail(f"nn_argmin disagrees with its plain version (flips {flips}, "
             f"gap {gap})")
    B, N, D = s.shape
    # 6 operations a (source, target) pair; inputs once, idx and matched out
    nbytes = 4 * (s.numel() + t.numel()) + tm.numel() + 4 * B * N * (1 + D)
    return flips, gap, ms, plain_ms, lib_ms, bound(nbytes,
                                                   6 * B * N * t.shape[1])


NN_EXACT = "indices equal to nn_argmin_rounded, matched bit-equal"


def visits(ends, masks, cfg, K) -> int:
    """Cells the ray walk visits: the in-map slot intervals of the valid
    rays (ops/raywalk.ray_descriptors)."""
    from lidar_slam_tpu_torch.ops.raywalk import ray_descriptors

    k_in, k_out = ray_descriptors(ends, masks, cfg, K)[-2:]
    return int((k_out - k_in + 1).clamp(min=0).sum())


def synced(data, sensors):
    enc = sensors.Encoder.from_data(data["encoder"])
    imu = sensors.Imu.from_data(data["imu"])
    lid = sensors.Lidar.from_data(data["lidar"])
    sensors.synchronize_sensors(enc, imu, lid, base_sensor_index=0)
    return (enc.counts_synced, imu.gyro_synced, lid.ranges_synced,
            float(lid.range_min), float(lid.range_max))


P9_TIME_PAIRS, P9_TIME_REPS = 64, 2  # the plain version loops in Python
HOT_CELL = (601, 300)


def hot_cell_updates(u: int):
    """P7's hot-cell case: u updates on random cells, every eighth on
    HOT_CELL, values of mixed sign and magnitude (so their order shows)."""
    from lidar_slam_tpu_torch.kernels import probes

    rng = np.random.default_rng(5)
    W, H = probes.GRID_SHAPE
    xs = rng.integers(0, W, u).astype(np.int32)
    ys = rng.integers(0, H, u).astype(np.int32)
    xs[::8], ys[::8] = HOT_CELL
    vs = (rng.choice([-1.0, 1.0], u) * 10.0 ** rng.uniform(-3, 3, u))
    return xs, ys, vs.astype(np.float32)


def one_tile_segments(n: int):
    """P8's hot case: n segments on the tile at (600, 512) in ten line
    shapes, so each cell of a line takes about n / 10 adds."""
    k = np.random.default_rng(6).integers(0, 10, n)
    return (np.full(n, 600, np.int32), np.full(n, 512, np.int32),
            (100 * k + 1).astype(np.int32), (700 * k).astype(np.int32))


HOT_N, P5_N = 65_536, 4096  # [10]'s second cases of P2-P4, P1 and P5


def hot_tile_entries(n: int):
    """P2-P4's hot case: n entries (xs, ys) on the (64, 256) grid, 7 in 8
    of them on the tile at rows [40, 48) x lanes [128, 256); P2 takes the
    xs alone, 7 in 8 of them in the row band [40, 48)."""
    from lidar_slam_tpu_torch.kernels import probes

    rng = np.random.default_rng(14)
    W, H = probes.PROBE_SHAPE
    xs = rng.integers(0, W, n).astype(np.int32)
    ys = rng.integers(0, H, n).astype(np.int32)
    hot = rng.random(n) < 7 / 8
    xs[hot] = rng.integers(40, 48, int(hot.sum()))
    ys[hot] = rng.integers(128, 256, int(hot.sum()))
    return xs, ys


def order_sensitive(n: int) -> np.ndarray:
    """P1's and P5's second case: [1e8, 1, -1e8, 1] repeated; in float32
    1e8 + 1 rounds to 1e8, so the in-order sum is 1.0 and a tree sum is
    not."""
    return np.tile(np.float32([1e8, 1.0, -1e8, 1.0]), n // 4)


def second_cases() -> dict:
    """{wrapper: (tag, label, arrays)} of [10]'s and [11]'s second cases
    of P1-P5 (P1 and P5 on the same order-sensitive entries)."""
    from lidar_slam_tpu_torch.kernels import probes

    xs, ys = hot_tile_entries(HOT_N)
    hot = f"hot tile n={HOT_N}"
    return {probes.smem_stream: (f"n{P5_N}", f"order-sensitive n={P5_N}",
                                 (order_sensitive(P5_N),)),
            probes.dynamic_store: ("hot_tile", hot, (xs,)),
            probes.dynamic_lane_store: ("hot_tile", hot, (xs, ys)),
            probes.masked_tile: ("hot_tile", hot, (xs, ys)),
            probes.scalar_sum: (f"n{P5_N}", f"order-sensitive n={P5_N}",
                                (order_sensitive(P5_N),))}


class ProbeCase(NamedTuple):
    """One probe comparison. check() returns (kernel output, plain version
    on CPU copies), the exactness check; kernel(), plain() and library()
    (one PyTorch call that computes the same function) are timed on the
    card; bytes count each input read and each output written once, ops
    the float adds, or for a masked tile the one test per tile cell that
    the mask needs."""
    fn: Callable
    label: str
    check: Callable
    kernel: Callable
    plain: Callable
    library: Callable
    nbytes: int
    ops: int
    reps: int
    tag: str = ""  # a second case of fn: its time goes to the row as ms_<tag>


def probe_cases(dev) -> list:
    """Every probe comparison, at the JAX probe tools' sizes. The library
    of the probes that add into a zero grid (P1-P4, P7, P8) is one
    index_add_ of their adds at precomputed flat cell indices; P9's is the
    same on its carried grid."""
    from lidar_slam_tpu_torch.kernels import probes
    from lidar_slam_tpu_torch.tools import (pallas_probe, scatter_microbench,
                                            vpu_probe)

    def adds_library(fn, g):
        flat, vals = probes.adds(fn, *g)
        return lambda: scatter_microbench.index_add(flat, vals, fn.shape)

    def case(fn, label, g, c, library, nbytes, ops, reps, tag=""):
        return ProbeCase(fn, label, lambda: (fn(*g), fn(*c)), lambda: fn(*g),
                         lambda: fn.plain(*g), library, nbytes, ops, reps,
                         tag)

    cases = []
    for name, fn in pallas_probe.KERNELS.items():
        arrays = pallas_probe.inputs(name)
        g = [torch.as_tensor(a, device=dev) for a in arrays] or [dev]
        c = [torch.as_tensor(a) for a in arrays] or ["cpu"]
        n = len(arrays[0]) if arrays else 0
        out_n = 1 if fn is probes.scalar_sum else int(np.prod(
            probes.GRID_SHAPE if fn is probes.full_grid
            else probes.PROBE_SHAPE))
        # P2 and P3 test each entry's tile once, in integers (no adds); P4
        # adds each entry into one cell; P1 and P5 fold the entries once
        ops = 0 if fn is probes.full_grid else n
        library = {probes.scalar_sum: lambda g=g: g[0].sum(),
                   probes.full_grid: lambda: torch.ones(
                       probes.GRID_SHAPE, device=dev)}.get(fn)
        cases.append(case(fn, name, g, c, library or adds_library(fn, g),
                          sum(a.nbytes for a in arrays) + 4 * out_n, ops, 50))
    for fn, (tag, label, arrays) in second_cases().items():
        g = [torch.as_tensor(a, device=dev) for a in arrays]
        n = len(arrays[0])
        sums = fn is probes.scalar_sum
        cases.append(case(
            fn, f"{fn.__name__} {label}", g,
            [torch.as_tensor(a) for a in arrays],
            (lambda g=g: g[0].sum()) if sums else adds_library(fn, g),
            sum(a.nbytes for a in arrays) + 4 * (1 if sums else int(
                np.prod(probes.PROBE_SHAPE))),
            n, 20, tag))
    u = scatter_microbench.UPDATES[0]
    grid_bytes = 4 * int(np.prod(probes.GRID_SHAPE))
    for label, arrays, tag in [
            (f"tile_rmw u={u}", scatter_microbench.make_updates(u, 0), ""),
            (f"tile_rmw hot cell u={u}", hot_cell_updates(u), "hot_cell")]:
        g = [torch.as_tensor(a, device=dev) for a in arrays]
        cases.append(case(probes.tile_rmw, label, g,
                          [torch.as_tensor(a) for a in arrays],
                          adds_library(probes.tile_rmw, g),
                          12 * u + grid_bytes, u, 20, tag))
    nseg = scatter_microbench.SEGMENTS[0]
    for label, arrays, tag in [
            (f"segment_rmw n={nseg}", scatter_microbench.seg_args(nseg, 0),
             ""),
            (f"segment_rmw one tile n={nseg}", one_tile_segments(nseg),
             "one_tile")]:
        g = [torch.as_tensor(a, device=dev) for a in arrays]
        cases.append(case(probes.segment_rmw, label, g,
                          [torch.as_tensor(a) for a in arrays],
                          adds_library(probes.segment_rmw, g),
                          16 * nseg + grid_bytes,
                          nseg * probes.TS * probes.LANES, 20, tag))

    # P9: checked at the tool's word table (m1 pairs, two repetitions: the
    # fullv staging rounds, the 4,096-column ray table wrapping, and each
    # block's list filtered once and walked twice); timed at a reduced pair
    # count, as its plain version loops in Python, and checked there too
    m1, n_p, reps = vpu_probe.M1, P9_TIME_PAIRS, P9_TIME_REPS
    shape = (vpu_probe.GRID, vpu_probe.GRID)
    grid = torch.as_tensor(np.random.default_rng(1).normal(0, 1, shape),
                           dtype=torch.float32)
    g_dev = grid.to(dev)
    for mode in probes.VPU_MODES:
        rays = mode in ("ray1", "ray2")
        big = torch.from_numpy(vpu_probe.words_for(m1, 12, rays=rays))
        words = torch.from_numpy(vpu_probe.words_for(n_p, 11, rays=rays))
        w_g, big_g = words.to(dev), big.to(dev)
        adds = list(probes.vpu_adds(words, n_p, mode, shape)) * reps
        flat = torch.cat([f for f, _ in adds]).to(dev)
        vals = torch.cat([v for _, v in adds]).to(dev)
        visits_per_iter = 1 if mode == "ray1" else 2
        cases.append(ProbeCase(
            probes.vpu_loop,
            f"vpu_loop {mode} (checked at {m1} pairs x 2 and timed at "
            f"{n_p} pairs x {reps})",
            lambda b=big_g, bc=big, m=mode: (
                probes.vpu_loop(b, g_dev.clone(), m1, m, 2),
                probes.vpu_loop(bc, grid.clone(), m1, m, 2)),
            lambda w=w_g, m=mode: probes.vpu_loop(w, g_dev.clone(), n_p, m,
                                                  reps),
            lambda w=w_g, m=mode: probes.vpu_loop_plain(w, g_dev.clone(),
                                                        n_p, m, reps),
            lambda f=flat, v=vals: g_dev.clone().view(-1).index_add_(0, f, v),
            words.numel() * 4 + 2 * grid.numel() * 4,
            reps * n_p * visits_per_iter * probes.VPU_TS * probes.LANES, 5))
    return cases


def probe_phase(dev) -> list:
    """[10]: each probe kernel against its plain version, bit-exact, timed
    in turns; then the three probe tools with the launch counters reset.
    Returns the probes' rows of the kernels line."""
    from lidar_slam_tpu_torch.kernels import probes
    from lidar_slam_tpu_torch.tools import (pallas_probe, scatter_microbench,
                                            vpu_probe)

    rows = {}
    for c in probe_cases(dev):
        got, want = c.check()
        torch.cuda.synchronize()
        err = float((got.cpu() - want).abs().max())
        if not torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32)):
            fail(f"{c.label} differs from its plain version (max |diff| "
                 f"{err})")
        ms, plain_ms, lib_ms = turns(c.plain, c.kernel, c.library, c.reps,
                                     1 if c.fn is probes.vpu_loop else None)
        b_ms, b_by = bound(c.nbytes, c.ops)
        k = c.kernel()
        if c.fn is probes.vpu_loop and not torch.equal(
                k.view(torch.int32), c.plain().view(torch.int32)):
            fail(f"{c.label}: the timed case differs from its plain version")
        lib_err = float((c.library().reshape(k.shape) - k).abs().max())
        print(f"[10] {c.label} vs plain: bit-exact; kernel {ms:.4f} ms, "
              f"plain on the GPU {plain_ms:.4f} ms, library {lib_ms:.4f} ms "
              f"(max |diff| to the kernel {lib_err}); bound {b_ms:.6f} ms "
              f"({b_by})", flush=True)
        # one row a kernel: P9's times are its `full` mode's, its error
        # the largest of the six modes; a tagged case adds ms_<tag>
        row = rows.setdefault(c.fn, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if c.tag:
            row[f"ms_{c.tag}"] = ms
        elif "ms" not in row or c.label.startswith("vpu_loop full "):
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, library_ms=lib_ms)

    for fn in probes.WRAPPERS:
        fn.launches = 0
    t0 = time.perf_counter()
    log = lambda m: print(f"[10] {m}", flush=True)  # noqa: E731
    pallas_probe.run(log)
    scatter_microbench.run(log)
    rows[probes.vpu_loop]["tool_slopes_ns"] = vpu_probe.run(log=log)[
        "slopes"]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in probes.WRAPPERS}
    print(f"[10] probe tools at the JAX tools' sizes: "
          f"{time.perf_counter() - t0:.1f} s; launches {launches}",
          flush=True)
    if min(launches.values()) == 0:
        fail(f"a probe kernel was not launched by the tools: {launches}")

    lines = {"smem_stream": "pallas_probe.py:38",
             "dynamic_store": "pallas_probe.py:64",
             "dynamic_lane_store": "pallas_probe.py:92",
             "masked_tile": "pallas_probe.py:122",
             "scalar_sum": "pallas_probe.py:159",
             "full_grid": "pallas_probe.py:176",
             "tile_rmw": "scatter_microbench.py:71",
             "segment_rmw": "scatter_microbench.py:115",
             "vpu_loop": "vpu_probe.py:76"}
    return [{"name": fn.__name__, "route": "cuda",
             "source": "lidar_slam_tpu_torch/csrc/probes.cu",
             "replaces": f"tools/{lines[fn.__name__]}",
             "launches": fn.launches, **row} for fn, row in rows.items()]


STAT_BAND_RTOL = 1e-6  # [12]: pooled float32 sums, card against CPU
DBSCAN_CHECK_SCANS = 256  # [12]: scans whose DBSCAN masks the CPU redoes
N_RGB_FRAMES, TEX_CHECK_FRAMES = 2407, 64  # [13]: dataset-20's RGB track


def filtered_phase(dev, log21, pts21, masks21, cfg) -> dict:
    """[12]: run_slam(mode="gtsam", filter_lidar=True) on the
    dataset-20-shaped log, once to warm up and once timed with K1's and
    K4's launch counters reset just before it. Gates: DBSCAN masks on the
    card equal to the CPU's on DBSCAN_CHECK_SCANS scans, bit for bit; the
    statistical threshold within STAT_BAND_RTOL of the CPU's and its masks
    equal but for points whose range lies within that band of it (counted);
    poses finite; K1's map against the plain scatter on CPU copies of its
    ray end cells, bit-exact. Returns the launch counts."""
    from lidar_slam_tpu_torch.kernels.nn import nn_argmin
    from lidar_slam_tpu_torch.kernels.raywalk import raywalk_build
    from lidar_slam_tpu_torch.models import occupancy, slam
    from lidar_slam_tpu_torch.ops import filters

    fc = cfg.filter
    slam.run_slam(*log21, mode="gtsam", filter_lidar=True, cfg=cfg,
                  device=dev)  # warm-up
    torch.cuda.synchronize()
    nn_argmin.launches = 0
    raywalk_build.launches = 0
    t0 = time.perf_counter()
    res = slam.run_slam(*log21, mode="gtsam", filter_lidar=True, cfg=cfg,
                        device=dev)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {"nn_argmin": nn_argmin.launches,
                "raywalk_build": raywalk_build.launches}
    n_scans, n_rays = pts21.shape[:2]
    print(f"[12] filtered gtsam (--filter_lidar), {n_scans} scans x {n_rays} "
          f"rays ({n_scans * n_rays ** 2 / 1e9:.2f} G DBSCAN point pairs): "
          f"total {total:.3f} s; " + ", ".join(
              f"{k} {v:.3f} s" for k, v in res.stage_seconds.items())
          + f"; launches {launches}", flush=True)
    if min(launches.values()) == 0:
        fail(f"a kernel was not launched on the filtered path: {launches}")
    if res.poses.shape != (n_scans, 3) or not np.isfinite(res.poses).all():
        fail("the filtered run's poses are not finite")

    # the masks the run used, again on the card, and the CPU's
    db = filters.dbscan_filter_scans(pts21, masks21, fc.dbscan_eps,
                                     fc.dbscan_min_samples)
    t1 = time.perf_counter()
    db_cpu = filters.dbscan_filter_scans(
        pts21[:DBSCAN_CHECK_SCANS].cpu(), masks21[:DBSCAN_CHECK_SCANS].cpu(),
        fc.dbscan_eps, fc.dbscan_min_samples)
    cpu_s = time.perf_counter() - t1
    db_diff = int((db[:DBSCAN_CHECK_SCANS].cpu() != db_cpu).sum())
    d, thresh = filters.statistical_threshold(pts21, db, fc.statistical_k_std)
    kept = db & (d < thresh)
    d_c, thresh_c = filters.statistical_threshold(pts21.cpu(), db.cpu(),
                                                  fc.statistical_k_std)
    kept_c = db.cpu() & (d_c < thresh_c)
    band = STAT_BAND_RTOL * abs(float(thresh_c))
    near = db.cpu() & ((d_c - thresh_c).abs() <= band)
    differ = kept.cpu() != kept_c
    rel = abs(float(thresh) - float(thresh_c)) / abs(float(thresh_c))
    n_valid, n_db, n_kept = (int(m.sum()) for m in (masks21, db, kept))
    print(f"[12] DBSCAN masks card vs CPU, {DBSCAN_CHECK_SCANS} scans: "
          f"{db_diff} differing (CPU {cpu_s:.2f} s); statistical threshold "
          f"card {float(thresh):.9g} m, CPU {float(thresh_c):.9g} m "
          f"(relative gap {rel:.3e}); {int(near.sum())} points within "
          f"{STAT_BAND_RTOL:g} of it, {int(differ.sum())} masks differing; "
          f"points valid {n_valid}, after DBSCAN {n_db}, kept {n_kept}",
          flush=True)
    if db_diff:
        fail("DBSCAN masks on the card differ from the CPU's")
    if rel > STAT_BAND_RTOL or bool((differ & ~near).any()):
        fail("the statistical filter on the card differs from the CPU's "
             "outside the threshold's band")
    if not n_valid > n_db > n_kept > 0:
        fail("a scan filter dropped nothing or everything")

    ends = occupancy.ray_ends(torch.as_tensor(res.poses, device=dev), pts21,
                              cfg.map)
    g_plain = occupancy.build_logodds_scatter(ends.cpu(), kept.cpu(),
                                              cfg.map, res.ray_cells)
    diff = float((torch.from_numpy(res.logodds) - g_plain).abs().max())
    same_grid = np.array_equal(res.grid_map,
                               occupancy.finalize_grid(g_plain).numpy())
    print(f"[12] filtered map (K={res.ray_cells}) vs plain (CPU scatter of "
          f"the kept rays): max |diff| {diff}, finalize_grid equal "
          f"{same_grid}, nonzero cells {int((g_plain != 0).sum())}",
          flush=True)
    if diff != 0.0 or not same_grid or int((g_plain != 0).sum()) < 1000:
        fail("the filtered run's map disagrees with the scatter path")
    return launches


def texture_phase(dev, cfg) -> None:
    """[13]: the texture of N_RGB_FRAMES frames of 480 x 640, made as
    bench.py makes them (16 base frames from seed 30 with a per-batch
    disparity offset, poses N(0, 5)), painted on the 1201 x 1201 map with
    projector="device": seconds a frame of a timed run after one of
    TEX_CHECK_FRAMES frames; gate: the card's painted cells and colors over
    those first frames equal to the same function's on the CPU, bit for
    bit."""
    from lidar_slam_tpu_torch.models import texture

    H, W = 480, 640
    rng = np.random.default_rng(30)
    base_disp = rng.integers(300, 800, (16, H, W)).astype(np.uint16)
    base_rgb = rng.integers(0, 255, (16, H, W, 3)).astype(np.uint8)
    poses = np.asarray(rng.normal(0, 5.0, (N_RGB_FRAMES, 3)), np.float32)
    grid = np.zeros((cfg.map.width, cfg.map.height), np.uint8)

    def loader(ids):
        off = np.uint16(int(ids[0]) % 97)
        return base_disp[:len(ids)] + off, base_rgb[:len(ids)]

    first = np.arange(TEX_CHECK_FRAMES)
    w_k, c_k = texture.paint_texture(poses, first, loader, cfg.map,
                                     cfg.camera, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    w_c, c_c = texture.paint_texture(poses, first, loader, cfg.map,
                                     cfg.camera, device="cpu")
    cpu_s = time.perf_counter() - t1
    same = torch.equal(w_k.cpu(), w_c) and torch.equal(c_k.cpu(), c_c)
    painted = int((w_c >= 0).sum())
    t0 = time.perf_counter()
    tex = texture.generate_texture_map(poses, np.arange(N_RGB_FRAMES),
                                       np.arange(N_RGB_FRAMES), grid, loader,
                                       cfg.map, cfg.camera, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    finite = bool(torch.isfinite(tex).all())
    cells = int((tex != 0).any(-1).sum())
    print(f"[13] texture, {N_RGB_FRAMES} frames of {H} x {W} on "
          f"{cfg.map.width} x {cfg.map.height} cells (projector device): "
          f"{wall:.3f} s, {wall / N_RGB_FRAMES * 1e3:.3f} ms a frame; "
          f"{cells} cells painted; first {TEX_CHECK_FRAMES} frames card vs "
          f"CPU: cells and colors equal {same}, {painted} cells painted "
          f"(CPU {cpu_s:.2f} s)", flush=True)
    if not same or painted < 1000:
        fail("the texture painted on the card differs from the CPU's")
    if not finite or tex.shape != (cfg.map.width, cfg.map.height, 3) \
            or cells < painted:
        fail("the texture map is malformed")


REVISIT_STEPS, REVERSE_LAP = 4956, 2468  # [14]: dataset-20 length
SMALL_REVISIT = dict(n_steps=360, n_rays=361, laps=2)  # [14] (e)
DIRECT_POSE_TOL, DIRECT_COST_RTOL = 1e-5, 1e-6  # tests/test_pose_graph.py


def revisit_phase(dev, cfg, log21, res5, pts21, masks21) -> dict:
    """[14]: revisit loop closures on the card. (a) the two-lap revisit
    world (4,956 x 1,081) with the descriptor proposer and the Cauchy
    kernel (direct solver) against the fixed proposer: a revisit kept, ATE
    below the fixed run's, poses finite, K1's map bit-exact against the
    plain scatter; (b) the reversed-lap world (4,956 steps) with
    estimate-seeded proximity within 2 m (tests/test_loop_detection.py's
    setting for this world), TrICP 0.55 and the Huber kernel, against
    fixed: a closure kept, ATE below fixed's; (c) PLICP scan matching on
    [5]'s log, ICP iterations against [5]'s; (d) [5]'s fixed graph by the
    banded, direct and CG solvers in float64 and float32, direct held to
    banded in float64 (the same LM iterations, poses within 1e-5, cost
    within rtol 1e-6); (e) a small
    revisit log on the card and on the CPU: the same kept revisit pairs,
    poses within 1e-3. Each run's K4 and K1 counters are reset just before
    it. Returns K4's and K1's launches over the revisit runs of (a), (b)."""
    import dataclasses

    from lidar_slam_tpu_torch import sensors
    from lidar_slam_tpu_torch.kernels.nn import nn_argmin
    from lidar_slam_tpu_torch.kernels.raywalk import raywalk_build
    from lidar_slam_tpu_torch.models import occupancy, odometry, pose_graph
    from lidar_slam_tpu_torch.models import slam
    from lidar_slam_tpu_torch.ops import icp as icp_ops
    from lidar_slam_tpu_torch.ops import scan as scan_ops
    from lidar_slam_tpu_torch.utils import io, metrics

    def with_pg(**pg):
        return dataclasses.replace(cfg, pose_graph=dataclasses.replace(
            cfg.pose_graph, **pg))

    def run(tag, args, run_cfg, gt=None, build_map=True):
        torch.cuda.synchronize()
        nn_argmin.launches = 0
        raywalk_build.launches = 0
        t0 = time.perf_counter()
        r = slam.run_slam(*args, mode="gtsam", cfg=run_cfg, device=dev,
                          build_map=build_map)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"nn_argmin": nn_argmin.launches,
                    "raywalk_build": raywalk_build.launches}
        kept = 0 if r.revisit_pairs is None else len(r.revisit_pairs)
        ate = (None if gt is None
               else metrics.ate_translation(r.poses, gt)["rmse"])
        print(f"[14] {tag}: total {wall:.3f} s; " + ", ".join(
            f"{k} {v:.3f} s" for k, v in r.stage_seconds.items())
            + f"; revisit proposals {r.revisit_proposed}, kept {kept}; "
            f"loop closures {r.n_loop_closures}; LM iterations "
            f"{r.lm_iterations}; ICP iterations mean "
            f"{r.scan_matching_iters.mean():.2f}; ATE "
            + ("-" if ate is None else f"{ate:.4f} m")
            + f"; launches {launches}", flush=True)
        if not np.isfinite(r.poses).all():
            fail(f"[14] {tag}: poses are not finite")
        if launches["nn_argmin"] == 0 or (build_map
                                           and launches["raywalk_build"] == 0):
            fail(f"[14] {tag}: a kernel was not launched: {launches}")
        return r, launches, kept, ate

    launches_rv = {"nn_argmin": 0, "raywalk_build": 0}
    # (a) descriptor loops on the two-lap world
    d_a = io.synthetic_revisit_dataset(n_steps=REVISIT_STEPS, n_rays=1081,
                                       laps=2)
    args_a = synced(d_a, sensors)
    gt_a = d_a["ground_truth"]
    _, _, _, ate_fa = run("(a) two-lap revisit world, fixed", args_a,
                          cfg, gt_a)
    r_a, l_a, kept_a, ate_a = run(
        "(a) two-lap revisit world, descriptor + cauchy", args_a,
        with_pg(loop_proposer="descriptor", robust_loss="cauchy"), gt_a)
    pts_a, masks_a = scan_ops.scans_to_points(
        torch.as_tensor(args_a[2], dtype=torch.float32, device=dev), 0.1,
        30.0, cfg.lidar)
    ends_a = occupancy.ray_ends(torch.as_tensor(r_a.poses, device=dev),
                                pts_a, cfg.map)
    g_plain = occupancy.build_logodds_scatter(ends_a.cpu(), masks_a.cpu(),
                                              cfg.map, r_a.ray_cells)
    diff_a = float((torch.from_numpy(r_a.logodds) - g_plain).abs().max())
    print(f"[14] (a) map (K={r_a.ray_cells}) vs plain (CPU scatter): max "
          f"|diff| {diff_a}, nonzero cells {int((g_plain != 0).sum())}",
          flush=True)
    if kept_a < 1 or not ate_a < ate_fa:
        fail("[14] (a) no revisit kept, or ATE not below the fixed run's")
    if diff_a != 0.0 or int((g_plain != 0).sum()) < 1000:
        fail("[14] (a) the revisit run's map disagrees with the scatter path")
    # (b) estimate-seeded proximity on the reversed lap
    d_b = io.synthetic_reverse_lap_dataset(n_lap=REVERSE_LAP, turn_steps=20,
                                           n_rays=1081)
    args_b = synced(d_b, sensors)
    gt_b = d_b["ground_truth"]
    _, _, _, ate_fb = run("(b) reversed-lap world, fixed", args_b, cfg, gt_b)
    r_b, l_b, kept_b, ate_b = run(
        "(b) reversed-lap world, seeded proximity (radius 2 m) + TrICP "
        "0.55 + huber", args_b,
        with_pg(loop_proposer="proximity", proximity_seed="estimate",
                proximity_trim=0.55, proximity_radius=2.0,
                robust_loss="huber"), gt_b)
    if kept_b < 1 or not ate_b < ate_fb:
        fail("[14] (b) no closure kept, or ATE not below the fixed run's")
    for k in launches_rv:
        launches_rv[k] = l_a[k] + l_b[k]
    # (c) PLICP on [5]'s log
    r_c, _, _, _ = run("(c) PLICP scan matching on [5]'s log", log21,
                       dataclasses.replace(cfg, icp=dataclasses.replace(
                           cfg.icp, metric="point_to_line")),
                       build_map=False)
    print(f"[14] (c) ICP iterations mean {r_c.scan_matching_iters.mean():.2f}"
          f" (max {int(r_c.scan_matching_iters.max())}) against [5]'s "
          f"{res5.scan_matching_iters.mean():.2f}", flush=True)
    # (d) the three solvers on [5]'s fixed graph
    counts21, gyro21 = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                        for a in log21[:2])
    md, my = odometry.max_step_gates(counts21, gyro21, cfg.robot.dt)
    cand = slam.loop_closure_candidates(pts21.shape[0], 10)
    loop_T, accept, _, _ = slam.compute_loop_closures(
        icp_ops.lift_to_3d(pts21), masks21, cand, 10, float(md), float(my))
    ci = torch.as_tensor(cand, dtype=torch.int64, device=dev)
    sol = {}
    # the gate runs in float64, as tests/test_pose_graph.py does: a chain
    # of 4,956 poses anchored at one end is conditioned near (4n/pi)^2, so
    # two exact float32 solvers part along its flattest directions (the
    # float32 pair is printed, not gated)
    for dt in (torch.float64, torch.float32):
        x0 = torch.as_tensor(res5.poses_scan_matching, device=dev).to(dt)
        rel = torch.as_tensor(res5.relative_poses_scan_matching,
                              device=dev).to(dt)
        for solver in ("banded", "direct", "cg"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt = pose_graph.optimize_trajectory(
                x0, rel, ci, ci + 10, loop_T.to(dt), accept,
                dataclasses.replace(cfg.pose_graph, solver=solver,
                                    fixed_interval=10))
            torch.cuda.synchronize()
            sol[dt, solver] = (opt, time.perf_counter() - t0)
    gaps = {}
    for dt in (torch.float64, torch.float32):
        (ob, sb), (od, sd), (oc, sc) = (sol[dt, k]
                                        for k in ("banded", "direct", "cg"))
        gaps[dt] = (float((od.poses - ob.poses).abs().max()),
                    abs(float(od.cost) - float(ob.cost)) / abs(float(ob.cost)))
        print(f"[14] (d) [5]'s fixed graph in {str(dt)[6:]} "
              f"({x0.shape[0]} poses, {int(accept.sum())}/{len(cand)} loops "
              f"live, direct's panel {1 + 3 * len(cand)} columns): banded "
              f"{ob.iterations} LM iterations, cost {float(ob.cost):.9g}, "
              f"{sb:.3f} s; direct {od.iterations}, {float(od.cost):.9g}, "
              f"{sd:.3f} s; cg {oc.iterations}, {float(oc.cost):.9g}, "
              f"{sc:.3f} s; direct vs banded: max pose diff "
              f"{gaps[dt][0]:.3e}, cost rel diff {gaps[dt][1]:.3e}",
              flush=True)
        if not torch.isfinite(oc.poses).all():
            fail("[14] (d) the CG solve is not finite")
    (ob, _), (od, _) = sol[torch.float64, "banded"], sol[torch.float64,
                                                         "direct"]
    if (od.iterations != ob.iterations
            or gaps[torch.float64][0] > DIRECT_POSE_TOL
            or gaps[torch.float64][1] > DIRECT_COST_RTOL):
        fail("[14] (d) the direct solve disagrees with the banded solve")
    # (e) a small revisit log on the card and on the CPU
    small = synced(io.synthetic_revisit_dataset(**SMALL_REVISIT), sensors)
    cfg_e = with_pg(loop_proposer="descriptor", robust_loss="cauchy")
    r_g = slam.run_slam(*small, mode="gtsam", cfg=cfg_e, device=dev,
                        build_map=False)
    r_c = slam.run_slam(*small, mode="gtsam", cfg=cfg_e, device="cpu",
                        build_map=False)
    pairs_g, pairs_c = (sorted(map(tuple, r.revisit_pairs.tolist()))
                        for r in (r_g, r_c))
    pose_e = float(np.abs(r_g.poses - r_c.poses).max())
    print(f"[14] (e) small revisit log ({SMALL_REVISIT['n_steps']} x "
          f"{SMALL_REVISIT['n_rays']}) card vs CPU: kept revisit pairs "
          f"{len(pairs_g)} and {len(pairs_c)}, equal {pairs_g == pairs_c}; "
          f"max pose diff {pose_e:.3e}", flush=True)
    if pairs_g != pairs_c or not pairs_g or pose_e > SMALL_POSE_TOL:
        fail("[14] (e) the card's revisit run disagrees with the CPU's")
    return launches_rv


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
    from lidar_slam_tpu_torch.kernels.raywalk import (OWNER_SIDE, raywalk_bins,
                                                      raywalk_bins_plain,
                                                      raywalk_build,
                                                      raywalk_scan)
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
    flips, gap, nn_ms, nn_plain_ms, nn_lib_ms, nn_bound = nn_check(
        pts3[1:65], pts3[:64], masks20[:64], 50)
    print(f"[3] nn_argmin, 64 x 1081 x 1081: {NN_EXACT}; vs plain: index "
          f"flips {flips:.5f}, max chosen-distance gap {gap:.3e}; kernel "
          f"{nn_ms:.4f} ms, plain {nn_plain_ms:.4f} ms, torch.cdist + argmin "
          f"{nn_lib_ms:.4f} ms; bound {nn_bound[0]:.5f} ms "
          f"({nn_bound[1]})", flush=True)

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
    b_k, e_k = raywalk_bins(ends32, masks20[:32], cfg.map, K20)
    b_p, e_p = raywalk_bins_plain(ends32.cpu(), masks20[:32].cpu(), cfg.map,
                                  K20)
    same_bins = torch.equal(b_k.cpu(), b_p) and torch.equal(e_k.cpu(), e_p)
    print(f"[4] raywalk_build vs plain (CPU scatter), 32 scans, K={K20}: "
          f"max |diff| {diff}, finalize_grid equal {same_final}, "
          f"nonzero cells {int((g_p != 0).sum())}; binning kernel's lists "
          f"({OWNER_SIDE} x {OWNER_SIDE} owners, {int(b_p[-1])} entries) "
          f"equal to the plain lists {same_bins}", flush=True)
    if diff != 0.0 or not same_final or int((g_p != 0).sum()) < 1000:
        fail("raywalk_build disagrees with the scatter path")
    if not same_bins or int(b_p[-1]) < 1000:
        fail("the binning kernel's lists differ from the plain lists")

    # 5. the main path at dataset-20 scale
    args = synced(io.synthetic_dataset(n_steps=4956, n_rays=1081, seed=21),
                  sensors)
    log21 = args
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
    # ray ends and masks read once, the grid written once; one add a visit
    rw_visits = visits(ends_main, masks21, cfg.map, K)
    rw_bound = bound(4 * ends_main.numel() + masks21.numel()
                     + 4 * cfg.map.width * cfg.map.height, rw_visits)
    print(f"[5] main-path map (4956 scans, K={K}) vs plain (CPU scatter): "
          f"max |diff| {diff_main}, finalize_grid equal {same_grid}; "
          f"raywalk_build {rw_ms:.3f} ms, plain scatter path on the GPU "
          f"{rw_plain_ms:.3f} ms; {rw_visits} visits, bound "
          f"{rw_bound[0]:.5f} ms ({rw_bound[1]})", flush=True)
    if diff_main != 0.0 or not same_grid:
        fail("the main path's map disagrees with the scatter path")
    # the binning kernel's lists at the main path's shapes (ray indices
    # near 5.4 M, cursors near 1.2e8) against the plain lists, computed by
    # plain PyTorch on the card (on the host it takes minutes)
    bounds_main, entries_main = raywalk_bins(ends_main, masks21, cfg.map, K)
    want_bounds, want_entries = raywalk_bins_plain(ends_main, masks21,
                                                   cfg.map, K)
    same_bins_main = (torch.equal(bounds_main, want_bounds)
                      and torch.equal(entries_main, want_entries))
    del want_bounds, want_entries, entries_main
    per_owner = (bounds_main[1:] - bounds_main[:-1]).cpu()
    hot = int(per_owner.max())
    bins_ms = cuda_ms(lambda: raywalk_bins(ends_main, masks21, cfg.map, K), 3)
    print(f"[5] raywalk_build owners {OWNER_SIDE} x {OWNER_SIDE}: "
          f"{int(bounds_main[-1])} list entries (ray-owner crossings), "
          f"equal to the plain lists {same_bins_main}; hottest owner {hot} "
          f"crossings ({rw_ms * 1e6 / hot:.1f} ns a crossing of the whole "
          f"build's CUDA-event time), {int((per_owner > 0).sum())}/"
          f"{per_owner.numel()} owners touched; binning (count, scan, fill) "
          f"{bins_ms:.3f} ms", flush=True)
    if not same_bins_main:
        fail("the binning kernel's lists differ from the plain lists on the "
             "main path's rays")

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
    # the gtsam CLI on the card: --save_logodds, then --load_poses on the
    # saved optimized poses must rebuild the same grid
    from lidar_slam_tpu_torch.__main__ import main as cli_main

    cli_dir = os.path.join(ROOT, "build", "chip_smoke", "cli")
    first, resumed = (os.path.join(cli_dir, f"{name}.npy")
                      for name in ("first", "resumed"))
    flags = ["--synthetic", "60", "--device", "cuda", "--output_dir",
             cli_dir]
    rc1 = cli_main(["--mode", "gtsam", *flags, "--save_logodds", first])
    rc2 = cli_main(["--load_poses",
                    os.path.join(cli_dir, "poses_optimized_20.npy"), *flags,
                    "--save_logodds", resumed])
    g1, g2 = np.load(first), np.load(resumed)
    same_cli = g1.shape == g2.shape and np.array_equal(g1.view(np.int32),
                                                       g2.view(np.int32))
    # and the CLI's map against run_slam's plain versions on the CPU, on
    # the dataset the CLI made (--synthetic 60, main.py's map flags)
    r_cli = slam.run_slam(*synced(io.synthetic_dataset(n_steps=60), sensors),
                          mode="gtsam",
                          cfg=SlamConfig(map=MapConfig.from_cli(0.05, 60, 60)),
                          device="cpu")
    cli_vs_cpu = float((occupancy.finalize_grid(torch.from_numpy(g1)).numpy()
                        != r_cli.grid_map).mean())
    print(f"[6] gtsam CLI on the card, 60 steps: --save_logodds, then "
          f"--load_poses poses_optimized_20.npy: resumed grid bit-equal "
          f"{same_cli}, {int((g1 != 0).sum())} nonzero cells; grid_map "
          f"cells differing from run_slam on the CPU {cli_vs_cpu:.5f}",
          flush=True)
    if rc1 or rc2 or not same_cli or int((g1 != 0).sum()) < 1000:
        fail("the CLI's --load_poses grid differs from its --save_logodds "
             "grid")
    if g1.shape != r_cli.logodds.shape or cli_vs_cpu > SMALL_GRID_TOL:
        fail("the CLI's map on the card disagrees with run_slam on the CPU")

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
    # the grid read and written once (the clip covers it), the scan's ends
    # and mask read once; one add a visit
    scan_bound = bound(8 * m_on.width * m_on.height + 17 * e_t.shape[0],
                       visits(e_t, m_t, m_on, K_on))
    pts3_21 = icp_ops.lift_to_3d(pts21)
    flips1, gap1, nn1_ms, nn1_plain_ms, nn1_lib_ms, nn1_bound = nn_check(
        pts3_21[101:102], pts3_21[100:101], masks21[100:101], 200)
    print(f"[7] per scan (CUDA events, 100 launches, kernel-plain turns "
          f"{t_plain[0]:.4f}/{t_k[0]:.4f}/{t_k[1]:.4f}/{t_plain[1]:.4f} ms):"
          f" raywalk_scan {scan_ms:.4f} ms, plain scatter + clamp on the GPU"
          f" {scan_plain_ms:.4f} ms; scan_delta (zero grid + unclipped walk)"
          f" {delta_ms:.4f} ms; bound {scan_bound[0]:.5f} ms "
          f"({scan_bound[1]}); nn_argmin B=1 1x1081x1081: {NN_EXACT}; flips "
          f"{flips1:.5f}, gap {gap1:.3e}, kernel {nn1_ms:.4f} ms, plain "
          f"{nn1_plain_ms:.4f} ms, torch.cdist + argmin {nn1_lib_ms:.4f} ms, "
          f"bound {nn1_bound[0]:.5f} ms ({nn1_bound[1]})", flush=True)

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

    probe_rows = probe_phase(dev)

    # 11. device time a launch (torch.profiler) beside the CUDA events
    dev_scan = device_ms(scan_kernel, 100, "raywalk_scan_kernel")
    dev_nn1 = device_ms(lambda: nn_argmin(pts3_21[101:102], pts3_21[100:101],
                                          masks21[100:101]), 200,
                        "nn_argmin_kernel")
    dev_nn = device_ms(lambda: nn_argmin(pts3[1:65], pts3[:64],
                                         masks20[:64]), 50,
                       "nn_argmin_kernel")

    def fmt(v, digits=4):
        return "not measured" if v is None else f"{v:.{digits}f} ms"

    def main_build():
        raywalk_build(ends_main, masks21, cfg.map, K)

    # a build launches the binning kernel twice (count, fill)
    bin_launch = device_ms(main_build, 3, "raywalk_bin_kernel")
    k1_ms = {"bin": None if bin_launch is None else 2 * bin_launch,
             "walk": device_ms(main_build, 3, "raywalk_walk_kernel")}
    dev_k1 = (None if None in k1_ms.values()
              else k1_ms["bin"] + k1_ms["walk"])
    per_crossing = ("" if k1_ms["walk"] is None else
                    f", {k1_ms['walk'] * 1e6 / hot:.1f} ns a crossing of "
                    f"the hottest owner ({hot})")
    print(f"[11] raywalk_build under torch.profiler, 3 main-path builds: "
          f"binning (count and fill passes) {fmt(k1_ms['bin'])}, walk "
          f"{fmt(k1_ms['walk'])} a build{per_crossing}; CUDA events "
          f"{rw_ms:.3f} ms a build", flush=True)

    # P1-P6 a launch on the JAX tool's inputs (P2-P5 also at [10]'s
    # second cases), then the host's side of P1-P6 and K4 at B = 1
    from lidar_slam_tpu_torch.kernels import probes
    from lidar_slam_tpu_torch.tools import (host_split, pallas_probe,
                                            scatter_microbench, vpu_probe)

    rows_by_name = {row["name"]: row for row in probe_rows}
    second = second_cases()
    for name, fn in pallas_probe.KERNELS.items():
        args = [torch.as_tensor(a, device=dev)
                for a in pallas_probe.inputs(name)] or [dev]
        kernel = ("fill_kernel" if fn is probes.full_grid
                  else f"{fn.__name__}_kernel")
        row = rows_by_name[fn.__name__]
        row["device_ms"] = device_ms(lambda: fn(*args), 100, kernel)
        more = ""
        if fn in second:
            tag, _, arrays = second[fn]
            args2 = [torch.as_tensor(a, device=dev) for a in arrays]
            row[f"device_ms_{tag}"] = device_ms(lambda: fn(*args2), 100,
                                                kernel)
            more = (f"; {tag} {fmt(row[f'device_ms_{tag}'], 5)}, CUDA "
                    f"events {row[f'ms_{tag}']:.4f} ms")
        print(f"[11] {fn.__name__} under torch.profiler, 100 launches: "
              f"{kernel} {fmt(row['device_ms'], 5)} a launch; CUDA events "
              f"{row['ms']:.4f} ms{more}", flush=True)
    split = host_split.run(lambda m: print(f"[11] {m}", flush=True))
    for label, t in split.items():
        if label in rows_by_name:
            rows_by_name[label]["host_us"] = t
    xs5 = torch.as_tensor(pallas_probe.inputs("v5_vmem_scalar_read")[0],
                          device=dev)
    for label, fn in (("scalar_sum", lambda: probes.scalar_sum(xs5)),
                      ("sum", lambda: xs5.sum()),
                      ("full_grid", lambda: probes.full_grid(dev)),
                      ("torch.ones", lambda: torch.ones(probes.GRID_SHAPE,
                                                        device=dev))):
        top = sorted(cpu_events(fn, 200).items(), key=lambda kv: -kv[1])[:6]
        print(f"[11] {label} under torch.profiler, CPU events, self us a "
              f"call: " + ", ".join(f"{k} {v:.2f}" for k, v in top),
              flush=True)

    # P9: [10]'s timed case and the tool's full mode at 8 repetitions
    g512 = torch.as_tensor(np.random.default_rng(1).normal(
        0, 1, (vpu_probe.GRID, vpu_probe.GRID)), dtype=torch.float32,
        device=dev)
    w_small = torch.as_tensor(vpu_probe.words_for(P9_TIME_PAIRS, 11),
                              device=dev)
    w_tool = torch.as_tensor(vpu_probe.words_for(vpu_probe.M1, 10),
                             device=dev)
    # one kernel, vpu_loop_kernel<2> in mode full, one launch a call
    p9_row = rows_by_name["vpu_loop"]
    p9_row["device_ms"] = device_ms(lambda: probes.vpu_loop(
        w_small, g512.clone(), P9_TIME_PAIRS, "full", P9_TIME_REPS), 100,
        "vpu_loop_kernel")
    p9_row["device_ms_full_16384x8"] = device_ms(lambda: probes.vpu_loop(
        w_tool, g512, vpu_probe.M1, "full", 8), 5, "vpu_loop_kernel")
    print(f"[11] vpu_loop under torch.profiler, its one kernel "
          f"vpu_loop_kernel<2> (mode full): {P9_TIME_PAIRS} pairs x "
          f"{P9_TIME_REPS}, 100 calls, {fmt(p9_row['device_ms'], 5)} a call "
          f"(CUDA events, with the grid's clone, {p9_row['ms']:.4f} ms); "
          f"{vpu_probe.M1} pairs x 8, 5 calls ({2 * vpu_probe.M1 * 8} "
          f"visits), {fmt(p9_row['device_ms_full_16384x8'])} a call",
          flush=True)

    # P7 and P8 a pass, at the probe tools' sizes

    g7 = [torch.as_tensor(a, device=dev) for a in
          scatter_microbench.make_updates(scatter_microbench.UPDATES[0], 0)]
    g8 = [torch.as_tensor(a, device=dev) for a in
          scatter_microbench.seg_args(scatter_microbench.SEGMENTS[0], 0)]
    passes = {
        "tile_rmw": pass_ms(lambda: probes.tile_rmw(*g7), 20, (
            "tile_rmw_count", "tile_rmw_scan", "tile_rmw_fill",
            "tile_rmw_sort", "tile_rmw_sum")),
        "segment_rmw": pass_ms(lambda: probes.segment_rmw(*g8), 20, (
            "segment_rmw_kernel",))}
    for row in probe_rows:
        if row["name"] in passes:
            ms_by = passes[row["name"]]
            row["device_ms"] = (None if None in ms_by.values()
                                else sum(ms_by.values()))
            row["device_ms_passes"] = ms_by
            print(f"[11] {row['name']} under torch.profiler, 20 calls at the "
                  f"tool's size: " + ", ".join(
                      f"{k} {fmt(v)}" for k, v in ms_by.items())
                  + f" a call, device {fmt(row['device_ms'])}; CUDA events "
                  f"{row['ms']:.4f} ms", flush=True)

    print(f"[11] device time a launch (torch.profiler) vs CUDA events: "
          f"raywalk_scan, 100 clipped scans, {fmt(dev_scan)} vs "
          f"{scan_ms:.4f} ms; nn_argmin B=1, 200 launches, {fmt(dev_nn1)} "
          f"vs {nn1_ms:.4f} ms; nn_argmin 64 pairs, 50 launches, "
          f"{fmt(dev_nn)} vs {nn_ms:.4f} ms", flush=True)
    st_p = online.init_state(pts21[0], masks21[0], cfg_on, n_max=8192,
                             K=K_on, device=dev)
    steps_p = iter(range(1, 121))

    def one_step():
        nonlocal st_p
        t = next(steps_p)
        st_p = online.online_step(st_p, counts21[t], gyro21[t], pts21[t],
                                  masks21[t], cfg_on, K=K_on)

    for _ in range(20):
        one_step()
    kern = device_kernels(one_step, 100)
    step_us = sum(v[0] for v in kern.values())
    share = {name: sum(v[0] for k, v in kern.items() if name in k) / step_us
             for name in ("raywalk_scan_kernel", "nn_argmin_kernel")
             } if step_us else {}
    print(f"[11] online step under torch.profiler, 100 steps: device time "
          f"{step_us / 100 / 1e3:.4f} ms a step, "
          f"{sum(v[1] for v in kern.values()) / 100:.1f} kernel launches a "
          f"step; shares of device time "
          + ", ".join(f"{k} {v:.3f}" for k, v in share.items()), flush=True)

    # 12. the filtered gtsam run; 13. the texture
    launches_f = filtered_phase(dev, log21, pts21, masks21, cfg)
    texture_phase(dev, cfg)
    # 14. revisit loop closures
    launches_rv = revisit_phase(dev, cfg, log21, res, pts21, masks21)

    print(card)
    # launches: the main paths' runs, gtsam [5] plus online [8]; the
    # filtered run's [12] apart
    print(json.dumps({"kernels": [
        {"name": "nn_argmin", "route": "cuda",
         "source": "lidar_slam_tpu_torch/csrc/nn.cu",
         "replaces": "lidar_slam_tpu/ops/pallas_nn.py:64",
         "launches": launches["nn_argmin"] + launches_on["nn_argmin"],
         "max_abs_err": max(gap, gap1), "ms": nn_ms,
         "plain_ms": nn_plain_ms, "bound_ms": nn_bound[0],
         "bound_by": nn_bound[1], "library_ms": nn_lib_ms,
         "device_ms": dev_nn, "ms_b1": nn1_ms, "plain_ms_b1": nn1_plain_ms,
         "library_ms_b1": nn1_lib_ms, "bound_ms_b1": nn1_bound[0],
         "device_ms_b1": dev_nn1, "host_us_b1": split["nn_argmin_b1"],
         "launches_filtered": launches_f["nn_argmin"],
         "launches_revisit": launches_rv["nn_argmin"]},
        # no PyTorch call walks Bresenham rays: no library time for K1, K2
        {"name": "raywalk_build", "route": "cuda",
         "source": "lidar_slam_tpu_torch/csrc/raywalk.cu",
         "replaces": "lidar_slam_tpu/ops/raywalk.py:608",
         "launches": launches["raywalk_build"]
         + launches_on["raywalk_build"],
         "max_abs_err": max(diff, diff_main, diff_k1),
         "ms": rw_ms, "plain_ms": rw_plain_ms, "bound_ms": rw_bound[0],
         "bound_by": rw_bound[1], "library_ms": None, "device_ms": dev_k1,
         "device_ms_bin": k1_ms["bin"], "device_ms_walk": k1_ms["walk"],
         "owner_side": OWNER_SIDE, "hot_crossings": hot,
         "launches_filtered": launches_f["raywalk_build"],
         "launches_revisit": launches_rv["raywalk_build"]},
        {"name": "raywalk_scan", "route": "cuda",
         "source": "lidar_slam_tpu_torch/csrc/raywalk.cu",
         "replaces": "lidar_slam_tpu/ops/raywalk.py:461",
         "launches": launches_on["raywalk_scan"],
         "max_abs_err": max(diff_scan, diff_delta, diff_k1),
         "ms": scan_ms, "plain_ms": scan_plain_ms,
         "bound_ms": scan_bound[0], "bound_by": scan_bound[1],
         "library_ms": None, "device_ms": dev_scan},
        *probe_rows,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
