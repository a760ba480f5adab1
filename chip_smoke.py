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
     within the index-flip gate of its plain version; icp_sweep_tail
     (K5) on the same chunk against its plain version from one carry,
     three sweeps a mode in lockstep, the error normalized and not (done,
     k and idx equal, T within 1e-5), then timed alone, beside its plain
     version, and in a whole sweep fused (K4 + K5) and op by op;
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
     the online path's B = 1, gated as in [3], and K5 there as in [3];
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
     pairs, icp_sweep_tail likewise; raywalk_build's binning and walk
     kernels over three main-path
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
     synthetic frames and poses) on the 1201 x 1201 map with each
     projector, "device", "native" (the C++ host projector, built with g++
     from lidar_slam_tpu_torch/csrc_host, its paint ops folded on the
     card) and "auto" (reporting native): seconds a frame of each; the
     device engine's cells and colors of the first 64 frames on the card
     equal to the CPU's, bit for bit; auto's texture equal to native's,
     and native's apart from the device engine's in exactly the 46
     boundary cells of the CPU record (tests/torch_texture_engines.py);
     whether the host built the native PNG decoder;
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
     K4 and K1 launches;
 15. particle filters and relocalization (pf_reloc_phase) on [5]'s log
     with a 15% encoder bias, on the 1201 x 1201 map: (a) pf_step streamed
     over 4,956 steps with 256 particles against K1's map of the ground
     truth (steps/s, per-step p50/p99, errors against ground truth and
     dead reckoning; the filter below dead reckoning); (b) PF-SLAM with no
     prior map, its causal map (4,956 raywalk_scan paints) bit-exact
     against K1 over its track; (c) relocalize_refined at the online
     CLI's budget for 4 scans on the ground-truth map and scan 600 on the
     1,200-step log's map (seconds, nodes a level, certificate, K4
     launches; each grid result equal to the CPU's; where the JAX
     package finds the pose, the refined pose within 1e-4 of the CPU's and
     5 cm and 0.03 rad of ground truth, elsewhere within 1e-3 of the
     CPU's; K4 held to its plain
     version on the polish's 8 x 1,081 x 4,096 inputs); (d)
     the kidnapped-robot stream of tests/test_online.py on the card and
     the CPU (the loss gate at step 300 only, recovered within 5 cm, card
     vs CPU within 1e-3); (e) a 60 x 181 log, 64 particles, card vs CPU
     on one noise, each computing its points (points equal, tracks and
     PF-SLAM maps within 1e-4, resample flags and hit maps equal);
 16. the 3-D ICP warm-up (warmup_phase): (a) the 5,000-point synthetic
     model against 4 target clouds, 24 yaw seeds in batches of 8, the NN
     kernel at D = 3 (seconds, iterations a seed, best error, K4
     launches; the best transform against the applied one, or against
     the CPU's where the reference's stopping rule misses it in the JAX
     package too; host syncs of one ICP iteration); (b) an 800-point
     model's sweeps card vs CPU (the same best seed and iteration counts);
     (c) nn_argmin on the first iteration's 8 x 5,000 x ~3,500 inputs held
     to nn_argmin_rounded and timed; (d) a 25,000-point sweep through
     voxel_downsample; (e) the warm-up CLI on the card and the CPU, the
     same "Best errors".
 17. the multi-rank layer (sharded_phase): 4 gloo ranks sharing the card
     (parallel/launch.run_ranks, after [2] built the kernels) run (a) the
     scan-sharded map of [3]'s seed-20 log (4,956 scans padded to 4,960,
     clamp-affine composition of K2 deltas) against raywalk_build, within
     1e-4 with finalize_grid equal, and again in one rank on NCCL; (b) the
     ray-sharded map of its first 256 scans likewise; (c) the
     factor-sharded LM on [5]'s graph in float64 against the banded
     optimize (float32 printed) and the banded-only refusal; (d) the
     superstep on a 64-scan window at full width on the (2, 2) mesh
     against the unsharded composition; (e) PF localization (500 steps,
     256 particles) and a relocalization at the CLI's budget with
     sharded scorers, bit-equal to the single-device runs; (f) 64 texture
     frames and their native paint ops, bit-equal; (g) [5]'s 4,955 ICP
     pairs, each rank's block equal to the block run alone; then (h)
     dryrun_multichip(4). Each prints its backend, world size, card
     count, wall and collective seconds, bytes and K2 and K4 launches a
     rank;
 18. block_tridiag (K6, tridiag_phase) at the offline cells' banded shape
     (496 blocks of 30 x 30, m = 1, q = 32) and at direct_solve's on
     dataset 20's 495 loops (4,956 blocks of 3 x 3, m = 1,486, q = 64),
     float32: against its plain version on the card, then timed in turns
     with the plain version and the op-by-op block_tridiag_solve, and its
     three kernels under torch.profiler. [5] and [12] gate K6's launches
     at three an LM iteration;
 19. the LM's factor work (K7, factors_phase: lm_linearize,
     lm_banded_system, lm_cost) at the offline cells' shape (4,956 poses,
     495 fixed-interval loops, about 150 live, band 10), float32 and
     float64: each entry against its plain version on the card, then timed
     by CUDA events and torch.profiler beside its plain version and the
     op-by-op function it replaced (_linearize, _banded_system, _cost
     called by name), with its bound; the device launches and host reads
     of one banded LM iteration; one whole float32 optimize at the
     filtered cell's LM schedule with K7 and op by op on the same card.
     [5] and [12] gate K7's launches at one linearization, one assembly
     and one cost an LM iteration (and the first cost).

The last three lines are the card's `name, power.limit`, a JSON object with
each kernel's launch count on its path ([5] and [8] for K1, K2, K4 and K5
(K5's equal to K4's there and in [15] (c), and 0 in [16] (a)), and
[12]'s and [14]'s revisit runs apart for K1 and K4, [15]'s runs apart for
K1 (a, c), K2 (b, d) and K4 (c, d); the tools' run in [10]
for P1-P9), its error against its plain version, its,
the plain version's and the library call's times, and its bound (the
larger of its bytes over 3.35 TB/s and its operations over 67 TFLOP/s,
the H100's published HBM and FP32 rates; nn_argmin also at B = 1, and
every kernel with its profiler device time; nn_argmin also on [15] (c)'s
polish inputs and on [16] (c)'s warm-up inputs, with [16]'s launches;
K2, K4 and K5 also with [17]'s launches over every rank; icp_sweep_tail
also at B = 1 and on [15] (c)'s polish inputs, with whole sweeps' times;
P1-P6 and nn_argmin at B = 1
with their host split; P9 also with the probe tool's slopes;
block_tridiag also at direct_solve's shape, beside the op-by-op solve, its
bound by float64 operations over 34 TFLOP/s, and with [12]'s launches;
lm_factors, K7's three entries together, beside the op-by-op functions,
with each entry's time and bound and [12]'s launches), and
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
# icp_sweep_tail (K5) against its plain version from one carry: the card
# tests' bound of the fused sweep against the op-by-op sweep (m, rad), and
# the error's relative gap (float64 sums on both sides)
K5_POSE_TOL, K5_ERR_RTOL = 1e-5, 1e-5
K5_SWEEPS = 3  # lockstep sweeps a case: the first skips the delta rule
# K5 a source point: src_t, matched, the mask, src and idx read, src_t and
# idx written (csrc/icp.cu); about 20 float64 operations
K5_BYTES, K5_OPS = 57, 20
FP64_OPS_S = 34e12  # H100 SXM FP64 outside the tensor cores, published
# [18] block_tridiag (K6) against its plain version on the card, both
# float64 inside, on float32 systems (the LM's dtype): each side rounds its
# solution once, so they part by about an ulp; relative to max |x|
K6_RTOL = 1e-6
# [18]: the offline cells' banded solve (fixed_interval 10 on 4,956 poses)
# and direct_solve on dataset 20's 495 fixed-interval loops: (n, b, m, q)
K6_SHAPES = {"banded": (496, 30, 1, 32), "direct": (4956, 3, 1 + 3 * 495, 64)}
# [19] K7 against its plain version on the card, both float64 inside:
# float64 within 1e-11 (the theta column's d(sin w / w)/dw cancels at
# small |omega|, so an ulp between CUDA's and the host's cosines reads
# 1e-12 of a block), float32 within 1e-6 (each side rounds once); the
# blocks relative to their largest entry, g and R to max(max |g|, 1), the
# cost to max(cost, 1) (tests/test_torch_kernels.py's bounds)
K7_RTOL = {torch.float64: 1e-11, torch.float32: 1e-6}
K7_MAX_LAUNCHES = 60  # device launches of one banded LM iteration
# float64 operations of one factor's residual and blocks (the closed form
# of csrc/factors.cu: about 150 multiply-adds and divisions, and sincos x 3
# and atan2 at about 20 each); a residual alone about 100
K7_FACTOR_OPS, K7_RESIDUAL_OPS = 250, 100
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


def fmt(v, digits=4) -> str:
    return "not measured" if v is None else f"{v:.{digits}f} ms"


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


def _pose_gap(Ta, Tb):
    """Largest translation (m) and yaw (rad) gap of two (B, 4, 4) batches."""
    dt = float((Ta[:, :2, 3] - Tb[:, :2, 3]).abs().max())
    yaw = [torch.atan2(T[:, 1, 0], T[:, 0, 0]) for T in (Ta, Tb)]
    dr = torch.remainder(yaw[0] - yaw[1] + np.pi, 2 * np.pi) - np.pi
    return dt, float(dr.abs().max())


def k5_line(shape: str, r) -> str:
    return (f"icp_sweep_tail, {shape}, {K5_SWEEPS} sweeps a mode against "
            f"its plain version from one carry: done, k and idx equal, max "
            f"T gap {r[0]:.3e} m, {r[1]:.3e} rad; kernel {r[2]:.4f} ms, "
            f"plain {r[3]:.4f} ms; a sweep (_icp_body) fused {r[4]:.4f} ms, "
            f"op by op {r[5]:.4f} ms; bound {r[6][0]:.5f} ms ({r[6][1]})")


def k5_check(s, t, sm, tm, reps: int):
    """icp_sweep_tail (K5) on (s, t, sm, tm) from the identity: against its
    plain version (icp_sweep_tail_plain, on the card) from the same carry,
    K5_SWEEPS sweeps in lockstep (each from K5's carry, so K4 sees one
    input), the error normalized and not, under scan matching's stopping
    rules: done, k and idx equal, T within K5_POSE_TOL, the error within
    K5_ERR_RTOL; then timed on a carry that never stops (epsilon and the
    threshold -1): K5 alone, its plain version, and a whole sweep through
    ops/icp._icp_body fused (K4 + K5) and op by op. Returns (max T gap m,
    rad; ms, plain ms, fused sweep ms, op-by-op sweep ms, the bound, and
    the timed K5 call for the profiler)."""
    from lidar_slam_tpu_torch.kernels.icp import (icp_sweep_tail,
                                                  icp_sweep_tail_plain)
    from lidar_slam_tpu_torch.kernels.nn import nn_argmin
    from lidar_slam_tpu_torch.ops import icp as icp_ops

    s, sm = s.contiguous(), sm.contiguous()
    B, N, _ = s.shape
    eye = torch.eye(4, device=s.device).expand(B, 4, 4)

    def clone(c):
        return c._replace(**{k: v.clone() for k, v in c._asdict().items()})

    gap_t = gap_r = 0.0
    for normalize in (False, True):
        c = icp_ops.initial_icp_carry(eye, N, torch.float32, s)
        for _ in range(K5_SWEEPS):
            p = clone(c)
            idx, matched = nn_argmin(c.src_t, t, tm)
            icp_sweep_tail(s, matched, idx, sm, c, normalize, 1e-3, 2000,
                           1e-4)
            icp_sweep_tail_plain(s, matched, idx, sm, p, normalize, 1e-3,
                                 2000, 1e-4)
            torch.cuda.synchronize()
            dt, dr = _pose_gap(c.T, p.T)
            gap_t, gap_r = max(gap_t, dt), max(gap_r, dr)
            if not (torch.equal(c.done, p.done) and torch.equal(c.k, p.k)
                    and torch.equal(c.idx, p.idx)):
                fail(f"icp_sweep_tail's done, k or idx differ from its "
                     f"plain version at {B} x {N} (normalized {normalize})")
            if dt > K5_POSE_TOL or dr > K5_POSE_TOL or not torch.allclose(
                    c.err, p.err, rtol=K5_ERR_RTOL, atol=0):
                fail(f"icp_sweep_tail's fit or error differs from its plain"
                     f" version at {B} x {N}: {dt:.3e} m, {dr:.3e} rad")
    never = (False, -1.0, 2 ** 30, -1.0)
    c = icp_ops.initial_icp_carry(eye, N, torch.float32, s)
    idx, matched = nn_argmin(c.src_t, t, tm)
    p, f = clone(c), clone(c)
    o = icp_ops.initial_icp_carry(eye, N, torch.float32)

    def k5():
        icp_sweep_tail(s, matched, idx, sm, c, *never)

    ms, plain_ms, _ = turns(
        lambda: icp_sweep_tail_plain(s, matched, idx, sm, p, *never), k5,
        None, reps)
    body = (never[1], never[2], never[3], never[0])
    sweep_ms, op_ms, _ = turns(
        lambda: icp_ops._icp_body(s, t, sm, tm, o, *body),
        lambda: icp_ops._icp_body(s, t, sm, tm, f, *body), None, reps)
    return (gap_t, gap_r, ms, plain_ms, sweep_ms, op_ms,
            bound(K5_BYTES * B * N, K5_OPS * B * N), k5)


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
# [13]: texture cells where the native engine (float64 chain) and the
# device engine (float32) part over the N_RGB_FRAMES frames, each reached
# by a pixel within 1e-4 cells or rows of a boundary: the CPU record of
# tests/torch_texture_engines.py
TEX_ENGINE_CELLS_APART = 46


def filtered_phase(dev, log21, pts21, masks21, cfg) -> dict:
    """[12]: run_slam(mode="gtsam", filter_lidar=True) on the
    dataset-20-shaped log, once to warm up and once timed with K1's and
    K4's launch counters reset just before it. Gates: DBSCAN masks on the
    card equal to the CPU's on DBSCAN_CHECK_SCANS scans, bit for bit; the
    statistical threshold within STAT_BAND_RTOL of the CPU's and its masks
    equal but for points whose range lies within that band of it (counted);
    poses finite; K1's map against the plain scatter on CPU copies of its
    ray end cells, bit-exact. Returns the launch counts (K5's too)."""
    from lidar_slam_tpu_torch.kernels.icp import icp_sweep_tail
    from lidar_slam_tpu_torch.kernels.nn import nn_argmin
    from lidar_slam_tpu_torch.kernels.raywalk import raywalk_build
    from lidar_slam_tpu_torch.kernels.tridiag import block_tridiag
    from lidar_slam_tpu_torch.kernels import factors as k7
    from lidar_slam_tpu_torch.models import occupancy, slam
    from lidar_slam_tpu_torch.ops import filters

    fc = cfg.filter
    slam.run_slam(*log21, mode="gtsam", filter_lidar=True, cfg=cfg,
                  device=dev)  # warm-up
    torch.cuda.synchronize()
    nn_argmin.launches = icp_sweep_tail.launches = 0
    raywalk_build.launches = block_tridiag.launches = 0
    k7.lm_linearize.launches = k7.lm_banded_system.launches = 0
    k7.lm_cost.launches = 0
    t0 = time.perf_counter()
    res = slam.run_slam(*log21, mode="gtsam", filter_lidar=True, cfg=cfg,
                        device=dev)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {"nn_argmin": nn_argmin.launches,
                "icp_sweep_tail": icp_sweep_tail.launches,
                "raywalk_build": raywalk_build.launches,
                "block_tridiag": block_tridiag.launches,
                **k7_launches()}
    n_scans, n_rays = pts21.shape[:2]
    print(f"[12] filtered gtsam (--filter_lidar), {n_scans} scans x {n_rays} "
          f"rays ({n_scans * n_rays ** 2 / 1e9:.2f} G DBSCAN point pairs): "
          f"total {total:.3f} s; " + ", ".join(
              f"{k} {v:.3f} s" for k, v in res.stage_seconds.items())
          + f"; launches {launches}", flush=True)
    if min(launches.values()) == 0:
        fail(f"a kernel was not launched on the filtered path: {launches}")
    if not k7_launches_ok(launches, res.lm_iterations):
        fail(f"[12] an LM iteration's factor work missed K7: {launches}")
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


def texture_frames():
    """(poses (N_RGB_FRAMES, 3) float32, loader): [13]'s RGB-D frames of
    480 x 640, made as bench.py makes them: 16 base frames from seed 30
    with a per-batch disparity offset, poses N(0, 5)."""
    H, W = 480, 640
    rng = np.random.default_rng(30)
    base_disp = rng.integers(300, 800, (16, H, W)).astype(np.uint16)
    base_rgb = rng.integers(0, 255, (16, H, W, 3)).astype(np.uint8)
    poses = np.asarray(rng.normal(0, 5.0, (N_RGB_FRAMES, 3)), np.float32)

    def loader(ids):
        off = np.uint16(int(ids[0]) % 97)
        return base_disp[:len(ids)] + off, base_rgb[:len(ids)]

    return poses, loader


def texture_phase(dev, cfg) -> None:
    """[13]: the texture of texture_frames()'s N_RGB_FRAMES frames painted
    on the 1201 x 1201 map by each engine: seconds a frame of a timed run
    with projector "device" (after one of TEX_CHECK_FRAMES frames), then
    "native" (the host projector's paint ops folded on the card) and
    "auto" (which must report native for the raw uint16 frames). Gates:
    the card's painted cells and colors over the first TEX_CHECK_FRAMES
    frames equal to the device engine's on the CPU, bit for bit; auto's
    texture equal to native's; the native texture apart from the device
    one in exactly TEX_ENGINE_CELLS_APART cells (the CPU record's count of
    boundary pixels' cells). Prints whether the host built the native PNG
    decoder and which decoder disk_frame_loader takes."""
    from lidar_slam_tpu_torch.models import texture
    from lidar_slam_tpu_torch.utils import native

    poses, loader = texture_frames()
    H, W = loader(np.arange(1))[0].shape[1:]
    grid = np.zeros((cfg.map.width, cfg.map.height), np.uint8)

    first = np.arange(TEX_CHECK_FRAMES)
    w_k, c_k, _ = texture.paint_texture(poses, first, loader, cfg.map,
                                        cfg.camera, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    w_c, c_c, _ = texture.paint_texture(poses, first, loader, cfg.map,
                                        cfg.camera, device="cpu")
    cpu_s = time.perf_counter() - t1
    same = torch.equal(w_k.cpu(), w_c) and torch.equal(c_k.cpu(), c_c)
    painted = int((w_c >= 0).sum())
    t0 = time.perf_counter()
    native.host_library()
    png = native.png_available()
    build_s = time.perf_counter() - t0
    tex, wall = {}, {}
    for engine in ("device", "native", "auto"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tex[engine], got = texture.generate_texture_map(
            poses, np.arange(N_RGB_FRAMES), np.arange(N_RGB_FRAMES), grid,
            loader, cfg.map, cfg.camera, projector=engine, device=dev)
        torch.cuda.synchronize()
        wall[engine] = time.perf_counter() - t0
        if got != ("device" if engine == "device" else "native"):
            fail(f"[13] projector {engine!r} painted with the {got} engine")
    t_dev = tex["device"]
    finite = bool(torch.isfinite(t_dev).all())
    cells = int((t_dev != 0).any(-1).sum())
    apart = int((t_dev != tex["native"]).any(-1).sum())
    auto_same = torch.equal(tex["auto"], tex["native"])
    print(f"[13] texture, {N_RGB_FRAMES} frames of {H} x {W} on "
          f"{cfg.map.width} x {cfg.map.height} cells: " + "; ".join(
              f"projector {e} {wall[e]:.3f} s, "
              f"{wall[e] / N_RGB_FRAMES * 1e3:.3f} ms a frame"
              for e in wall) + f"; {cells} cells painted; first "
          f"{TEX_CHECK_FRAMES} frames card vs CPU (device engine): cells and "
          f"colors equal {same}, {painted} cells painted (CPU {cpu_s:.2f} "
          f"s)", flush=True)
    print(f"[13] native engine: host libraries built in {build_s:.2f} s; "
          f"libpng on this host {png} (disk_frame_loader decodes with "
          f"{texture.disk_frame_loader(20, np.arange(1)).engine}); auto "
          f"reported native, its texture equal to native's {auto_same}; "
          f"cells apart from the device engine's {apart} (the CPU record's "
          f"{TEX_ENGINE_CELLS_APART}, tests/torch_texture_engines.py)",
          flush=True)
    if not same or painted < 1000:
        fail("the texture painted on the card differs from the CPU's")
    if not finite or t_dev.shape != (cfg.map.width, cfg.map.height, 3) \
            or cells < painted:
        fail("the texture map is malformed")
    if not auto_same or apart != TEX_ENGINE_CELLS_APART:
        fail("[13] the native engine's texture differs from the device "
             "engine's beyond the recorded boundary cells")


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
    it. Returns K4's, K5's and K1's launches over the revisit runs of (a),
    (b)."""
    import dataclasses

    from lidar_slam_tpu_torch import sensors
    from lidar_slam_tpu_torch.kernels.icp import icp_sweep_tail
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
        nn_argmin.launches = icp_sweep_tail.launches = 0
        raywalk_build.launches = 0
        t0 = time.perf_counter()
        r = slam.run_slam(*args, mode="gtsam", cfg=run_cfg, device=dev,
                          build_map=build_map)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"nn_argmin": nn_argmin.launches,
                    "icp_sweep_tail": icp_sweep_tail.launches,
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

    launches_rv = {"nn_argmin": 0, "icp_sweep_tail": 0, "raywalk_build": 0}
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


PF_PARTICLES = 256  # [15] (a), (b): the online CLI's --particles default
RELOC_SCANS = (600, 1800, 3000, 4200)  # [15] (c): spread over the log
# [15] (c): on the whole log's ground-truth map (3,806 occupied cells: the
# later passes' free-space rays carve the walls) the search misses these
# scans in the JAX package too: its relocalize_refined on the CPU gives the
# same grid results and refined poses 0.76-16.65 m off
# (tests/torch_reloc_full_map.py). They stay in the card-against-CPU gates.
RELOC_ALGORITHM_MISSES = RELOC_SCANS
# [15] (c): scan 600 of the generator's 1,200-step log (seed 21; a smaller
# room, so shorter rays) on that log's ground-truth map, which both
# packages relocalize, certified, and refine within the gate
RELOC_GATED_SCAN, RELOC_GATED_STEPS = 600, 1200
RELOC_POS_TOL, RELOC_YAW_TOL = 0.05, 0.03  # [15] (c), (d): m, rad
# [15] (c): card against CPU, refined poses. Where the pose is found the
# polish converges (ICP error ~2e-6) and the two agree within 1e-4. On the
# misses it ends in wrong basins (ICP error 9e-4 to 9e-3) whose nearest-
# neighbour near-ties flip between the card's kernel and the CPU's plain
# search, and whose Kabsch sums the two devices add in other orders: the
# refined poses part by up to 2.27e-4 (scan 600), and on the CPU alone the
# kernel's rounding in place of the plain search moves them by up to
# 7.4e-5 (tests/torch_reloc_full_map.py). Those are held to SMALL_POSE_TOL.
RELOC_REFINED_TOL = 1e-4
NN_STAGE = 2048  # csrc/nn.cu: targets a shared-memory stage
# [15] (c): nn_argmin is held to its plain version on this scan's polish
# inputs: its 8 candidates' target windows hold 3,294-3,806 occupied cells,
# so valid targets fill both NN_STAGE stages of the 4,096
RELOC_NN_SCAN = 1800
SMALL_PF = dict(n_steps=60, n_rays=181, seed=5)  # [15] (e)
SMALL_PF_TOL = 1e-4  # [15] (e): card against CPU, tracks and maps


def pos_err(poses, gt) -> np.ndarray:
    return np.linalg.norm(np.asarray(poses)[:, :2] - np.asarray(gt)[:, :2],
                          axis=1)


def yaw_err(a: float, b: float) -> float:
    return abs((a - b + np.pi) % (2 * np.pi) - np.pi)


def pf_reloc_phase(dev, cfg) -> tuple:
    """[15]: particle filters and relocalization on the card, at dataset-20
    width (the seed-21 log, 4,956 x 1,081, on the online CLI's 1201 x 1201
    map at 0.05 m) from a 15% encoder bias. (a) pf_step streamed over the
    log with 256 particles against the known map (K1 over the ground
    truth): steps/s, per-step p50/p99, mean and final error against ground
    truth and dead reckoning; the filter's mean error below dead
    reckoning's. (b) slam_particle_filter, no prior map, K2's counter reset
    before it: the causal map bit-exact against K1 over the returned
    track. (c) relocalize_refined at the online CLI's budget (centred,
    radius half the map's diagonal, 360 angles, beam 4096, 256 rays, 8
    candidates) for 4 scans on the ground-truth map and for scan 600 on
    the 1,200-step log's map (K1 again): each grid result equal to the
    CPU's; where the JAX package finds the pose too (not
    RELOC_ALGORITHM_MISSES), the refined pose within 1e-4 of the CPU's and
    5 cm and 0.03 rad of ground truth, elsewhere within SMALL_POSE_TOL of
    the CPU's (RELOC_REFINED_TOL says why); nn_argmin held to its plain
    version on scan RELOC_NN_SCAN's polish inputs (8 x 1,081 x 4,096),
    icp_sweep_tail (K5) to its plain version there (k5_check), and K5's
    launches over the calls equal to K4's (every polish sweep fused).
    (d) the kidnapped-robot stream (utils/io.kidnap_log) with
    relocalize_and_reseed on the card and on the CPU: the loss gate at
    step 300 only, the recovery within 5 cm and 0.03 rad, card and CPU
    poses within 1e-3. (e) a 60 x 181 log with 64 particles on the card
    and the CPU, each computing its own points, on one noise: points
    equal, tracks within 1e-4, resample flags equal, PF-SLAM maps within
    1e-4 with equal hit maps. Returns the launches of K1 in (a) and (c),
    of K2 in (b) and (d), of K4 and K5 in (c) and (d), and nn_check's
    numbers, k5_check's and K5's profiled device ms on the polish
    inputs."""
    import dataclasses
    import math

    from lidar_slam_tpu_torch.config import MapConfig, OnlineConfig
    from lidar_slam_tpu_torch.config import SlamConfig
    from lidar_slam_tpu_torch.kernels.icp import icp_sweep_tail
    from lidar_slam_tpu_torch.kernels.nn import nn_argmin
    from lidar_slam_tpu_torch.kernels.raywalk import (raywalk_build,
                                                      raywalk_scan)
    from lidar_slam_tpu_torch.models import occupancy, odometry, online
    from lidar_slam_tpu_torch.models import particle_filter as pf
    from lidar_slam_tpu_torch.models import pf_slam
    from lidar_slam_tpu_torch.models import relocalization as rl
    from lidar_slam_tpu_torch.ops import scan as scan_ops
    from lidar_slam_tpu_torch.utils import io

    m = MapConfig.from_cli(0.05, 60, 60)
    K = occupancy.max_ray_cells(m, 30.0)
    d = io.synthetic_dataset(n_steps=4956, n_rays=1081, seed=21)

    def f32(a, device=dev):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)

    gt_np = np.asarray(d["ground_truth"], np.float32)
    gt = f32(gt_np)
    counts = f32(d["encoder"]["counts"]) * 1.15
    gyro = f32(d["imu"]["angular_velocity"])
    pts, masks = scan_ops.scans_to_points(f32(d["lidar"]["ranges"]), 0.1,
                                          30.0, cfg.lidar)
    n = pts.shape[0]
    odo = odometry.poses_from_odometry(counts, gyro, x_0=gt[0]).cpu()
    err_odo = pos_err(odo, gt_np)
    launches = {}

    # (a) PF localization against the known map
    torch.cuda.synchronize()
    raywalk_build.launches = 0
    lo_gt = occupancy.build_logodds(gt, pts, masks, m, K)
    launches["raywalk_build"] = raywalk_build.launches
    im = rl.hit_map(lo_gt)
    pcfg = pf.PFConfig(n_particles=PF_PARTICLES)
    v_all = odometry.v_from_encoder(counts)
    w_all = gyro[:, -1]

    def localize(steps):
        st = pf.init_pf_state(pcfg, gt[0], seed=0, device=dev)
        track, step_s = [gt[0]], []
        for t in range(1, steps):
            t0 = time.perf_counter()
            st, (est, _, _) = pf.pf_step(st, v_all[t], w_all[t], pts[t],
                                         masks[t], im, m, pcfg)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            track.append(est)
        return torch.stack(track).cpu().numpy(), np.asarray(step_s)

    localize(50)  # warm-up
    track_a, step_s = localize(n)
    err_a = pos_err(track_a, gt_np)
    p50, p99 = (float(np.percentile(step_s, q)) * 1e3 for q in (50, 99))
    print(f"[15] (a) PF localization, {n} steps x 1081 rays, "
          f"{PF_PARTICLES} particles, 1201 x 1201 known map (K1 over the "
          f"ground truth, launches {launches['raywalk_build']}): "
          f"{(n - 1) / step_s.sum():.1f} steps/s, per-step p50 {p50:.3f} "
          f"ms, p99 {p99:.3f} ms; position error mean {err_a.mean():.4f} m, "
          f"final {err_a[-1]:.4f} m; dead reckoning (15% encoder bias) mean "
          f"{err_odo.mean():.4f} m, final {err_odo[-1]:.4f} m", flush=True)
    if not np.isfinite(track_a).all():
        fail("[15] (a) the PF track is not finite")
    if not err_a.mean() < err_odo.mean():
        fail("[15] (a) the filter's mean error is not below dead "
             "reckoning's")

    # (b) PF-SLAM, no prior map
    pf_slam.slam_particle_filter(counts[:50], gyro[:50], pts[:50],
                                 masks[:50], m, pcfg, x0=gt[0], K=K,
                                 device=dev)  # warm-up
    torch.cuda.synchronize()
    raywalk_scan.launches = 0
    t0 = time.perf_counter()
    track_b, lo_b, aux_b = pf_slam.slam_particle_filter(
        counts, gyro, pts, masks, m, pcfg, x0=gt[0], K=K, seed=0, device=dev)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    launches["raywalk_scan"] = raywalk_scan.launches
    g_k1 = raywalk_build(occupancy.ray_ends(track_b, pts, m), masks, m, K)
    diff_b = float((lo_b - g_k1).abs().max())
    track_b = track_b.cpu().numpy()
    err_b = pos_err(track_b, gt_np)
    print(f"[15] (b) PF-SLAM, {n} steps, {PF_PARTICLES} particles, no prior "
          f"map: {(n - 1) / wall_b:.1f} steps/s ({wall_b:.3f} s), "
          f"{int(aux_b['resampled'].sum())} resamples; position error mean "
          f"{err_b.mean():.4f} m, final {err_b[-1]:.4f} m (dead reckoning "
          f"{err_odo.mean():.4f}, {err_odo[-1]:.4f}); raywalk_scan launches "
          f"{launches['raywalk_scan']}; causal map vs raywalk_build over the "
          f"track: max |diff| {diff_b}, occupied cells "
          f"{int((lo_b > 0).sum())}", flush=True)
    if not np.isfinite(track_b).all():
        fail("[15] (b) the PF-SLAM track is not finite")
    if launches["raywalk_scan"] != n:
        fail(f"[15] (b) raywalk_scan launched {launches['raywalk_scan']} "
             f"times, expected {n}")
    if diff_b != 0.0 or int((lo_b > 0).sum()) < 1000:
        fail("[15] (b) the causal map disagrees with raywalk_build")

    # (c) global relocalization at the online CLI's budget
    rcfg = rl.RelocConfig(search_radius=0.5 * math.hypot(60.0, 60.0),
                          beam=4096, n_angles=360, max_rays=256)
    S = int(np.ceil(rcfg.search_radius / m.resolution))
    T = -((-(2 * S + 1)) // (1 << (rcfg.n_levels - 1)))
    nodes = [rcfg.n_angles * T * T] + [4 * rcfg.beam] * (rcfg.n_levels - 1)
    center = (0.0, 0.0)
    d_s = io.synthetic_dataset(n_steps=RELOC_GATED_STEPS, n_rays=1081,
                               seed=21)
    gt_s = np.asarray(d_s["ground_truth"], np.float32)
    pts_s, masks_s = scan_ops.scans_to_points(f32(d_s["lidar"]["ranges"]),
                                              0.1, 30.0, cfg.lidar)
    torch.cuda.synchronize()
    raywalk_build.launches = 0
    lo_s = occupancy.build_logodds(f32(gt_s), pts_s, masks_s, m, K)
    launches["raywalk_build"] += raywalk_build.launches
    # (map name, map, the log's points, masks and ground truth, scan,
    # refined-pose gate)
    cases = [("the log's map", lo_gt, pts, masks, gt_np, k,
              k not in RELOC_ALGORITHM_MISSES) for k in RELOC_SCANS]
    cases.append((f"the {RELOC_GATED_STEPS}-step log's map", lo_s, pts_s,
                  masks_s, gt_s, RELOC_GATED_SCAN, True))
    rl.relocalize_refined(lo_gt, m, pts[RELOC_SCANS[0]],
                          masks[RELOC_SCANS[0]], rcfg, center,
                          n_candidates=8)  # warm-up
    torch.cuda.synchronize()
    nn_argmin.launches = icp_sweep_tail.launches = 0
    results = []
    for name, lo, p_, m_, gt_, k, gated in cases:
        t0 = time.perf_counter()
        g, r, e = rl.relocalize_refined(lo, m, p_[k], m_[k], rcfg, center,
                                        n_candidates=8)
        torch.cuda.synchronize()
        results.append((name, lo, p_[k], m_[k], gt_[k], k, gated, g,
                        r.cpu(), float(e), time.perf_counter() - t0))
    launches["nn_argmin"] = nn_argmin.launches
    launches["icp_sweep_tail"] = icp_sweep_tail.launches
    bad = []
    for name, _, _, _, gk, k, gated, g, r, e, sec in results:
        gp, r = g.pose.cpu().numpy(), r.numpy()
        ge, re_ = (float(np.hypot(*(p[:2] - gk[:2]))) for p in (gp, r))
        print(f"[15] (c) relocalize scan {k} on {name}: {sec:.3f} s; nodes "
              f"scored a level {nodes}; grid score {float(g.score):.0f}, "
              f"certified {bool(g.certified)}, pruned_margin "
              f"{float(g.pruned_margin):.0f}; grid pose error {ge:.4f} m, "
              f"{yaw_err(gp[2], gk[2]):.4f} rad; refined {re_:.4f} m, "
              f"{yaw_err(r[2], gk[2]):.4f} rad (ICP error {e:.3e})",
              flush=True)
        if gated and (re_ > RELOC_POS_TOL
                      or yaw_err(r[2], gk[2]) > RELOC_YAW_TOL):
            bad.append((k, name))
    # each call again on the CPU: the grid result exactly equal (node
    # scores are integer sums, so equal base cells give equal results; the
    # base cells' card-against-CPU differences are counted, and where any
    # differ the CPU searches from the card's base cells), the refined pose
    # within RELOC_REFINED_TOL where found, SMALL_POSE_TOL on the misses
    angles = rl._angles(rcfg)
    ctr = torch.tensor(center, dtype=torch.float32)
    for name, lo, pk, mk, _, k, gated, g, r, _, _ in results:
        base_g = rl._base_cells(pk, mk, ctr.to(dev), angles, m,
                                rcfg.max_rays)
        base_c = rl._base_cells(pk.cpu(), mk.cpu(), ctr, angles, m,
                                rcfg.max_rays)
        flips = sum(int((a.cpu() != b).sum()) for a, b in zip(base_g,
                                                              base_c))
        t0 = time.perf_counter()
        g_c, r_c, _ = rl.relocalize_refined(lo.cpu(), m, pk.cpu(), mk.cpu(),
                                            rcfg, center, n_candidates=8)
        cpu_s = time.perf_counter() - t0
        if flips:
            g_c = rl.search(rl.hit_map(lo.cpu()), m,
                            tuple(b.cpu() for b in base_g), rcfg, center)
        same = all(torch.equal(a.cpu(), b) for a, b in
                   zip(g, (g_c.pose, g_c.score, g_c.certified,
                           g_c.pruned_margin)))
        gap = float((r - r_c).abs().max())
        tol = RELOC_REFINED_TOL if gated else SMALL_POSE_TOL
        print(f"[15] (c) scan {k} on {name}, card vs CPU (CPU "
              f"relocalize_refined {cpu_s:.1f} s; base cells differing: "
              f"{flips}): grid pose, score, certificate and margin equal "
              f"{same}; refined pose max diff {gap:.3e} (gate {tol:g})",
              flush=True)
        if not same:
            fail(f"[15] (c) scan {k}: the card's grid result differs from "
                 f"the CPU's")
        if gap > tol:
            fail(f"[15] (c) scan {k}: the card's refined pose differs from "
                 f"the CPU's")
    # nn_argmin on the polish's first ICP iteration (the ICP starts from
    # the identity): 8 candidates x 1,081 sources x 4,096 targets, valid
    # targets past the first NN_STAGE, so the kernel's staged loop runs
    k = RELOC_NN_SCAN
    _, leaves = rl.relocalize(im, m, pts[k], masks[k], rcfg, center,
                              return_leaves=True)
    cand, _ = rl.top_candidates(leaves, angles, center, m, 8)
    s_p, t_p, sm_p, tm_p = rl.polish_inputs(lo_gt, m, pts[k], masks[k],
                                            cand, rcfg)
    past = int(tm_p[:, NN_STAGE:].sum())
    nn_r = nn_check(s_p, t_p, tm_p, 20)
    print(f"[15] (c) nn_argmin on scan {k}'s polish inputs, "
          f"{' x '.join(map(str, (*s_p.shape[:2], t_p.shape[1])))} "
          f"(valid targets a candidate {tm_p.sum(-1).tolist()}, {past} past "
          f"the first {NN_STAGE}-target stage): {NN_EXACT}; vs plain: index "
          f"flips {nn_r[0]:.5f}, max chosen-distance gap {nn_r[1]:.3e}; "
          f"kernel {nn_r[2]:.4f} ms, plain {nn_r[3]:.4f} ms, torch.cdist + "
          f"argmin {nn_r[4]:.4f} ms; bound {nn_r[5][0]:.5f} ms "
          f"({nn_r[5][1]})", flush=True)
    if past == 0:
        fail("[15] (c) the polish's targets never reach nn_argmin's second "
             "stage")
    k5_r = k5_check(s_p, t_p, sm_p, tm_p, 20)
    dev_k5 = device_ms(k5_r[7], 20, "icp_sweep_tail_kernel")
    shape = ' x '.join(map(str, (*s_p.shape[:2], t_p.shape[1])))
    print(f"[15] (c) {k5_line(shape, k5_r)}; under torch.profiler "
          f"{fmt(dev_k5, 5)}", flush=True)
    print(f"[15] (c) nn_argmin launches over the {len(results)} calls "
          f"{launches['nn_argmin']}, icp_sweep_tail "
          f"{launches['icp_sweep_tail']}; refined-pose gate on "
          f"{[(r[5], r[0]) for r in results if r[6]]} "
          f"(the others miss in the JAX package too)", flush=True)
    if launches["nn_argmin"] == 0:
        fail("[15] (c) nn_argmin was not launched by the polish")
    if launches["icp_sweep_tail"] != launches["nn_argmin"]:
        fail("[15] (c) a polish sweep missed the fused path")
    if bad:
        fail(f"[15] (c) refined poses off ground truth for scans {bad}")

    # (d) the kidnapped-robot stream, card and CPU
    counts_k, gyro_k, ranges_k, gt_k = io.kidnap_log()
    base = SlamConfig()
    cfg_k = dataclasses.replace(
        base, map=MapConfig(resolution=0.1, world_min_x=-15.0,
                            world_max_x=15.0, world_min_y=-15.0,
                            world_max_y=15.0),
        icp=dataclasses.replace(base.icp, metric="point_to_line"),
        online=OnlineConfig(loss_rms_thresh=0.3))
    Kk = online.default_ray_cells(cfg_k, 30.0)

    def kidnap_stream(device):
        pk, mk = scan_ops.scans_to_points(f32(ranges_k, device), 0.1, 30.0,
                                          cfg_k.lidar)
        ck, gk = f32(counts_k, device), f32(gyro_k, device)
        st = online.init_state(pk[0], mk[0], cfg_k, n_max=512, K=Kk,
                               device=device)
        track, fired, t0 = [st.pose], [], time.perf_counter()
        for t in range(1, pk.shape[0]):
            st = online.online_step(st, ck[t], gk[t], pk[t], mk[t], cfg_k,
                                    K=Kk)
            if float(st.match_rms) > cfg_k.online.loss_rms_thresh:
                fired.append(t)
                st, _, _ = online.relocalize_and_reseed(st, cfg_k, K=Kk)
            track.append(st.pose)
        return (torch.stack(track).cpu().numpy(), fired,
                time.perf_counter() - t0)

    torch.cuda.synchronize()
    raywalk_scan.launches = nn_argmin.launches = 0
    icp_sweep_tail.launches = 0
    track_g, fired_g, wall_g = kidnap_stream(dev)
    l_scan, l_nn = raywalk_scan.launches, nn_argmin.launches
    l_k5 = icp_sweep_tail.launches
    launches["raywalk_scan"] += l_scan
    launches["nn_argmin"] += l_nn
    launches["icp_sweep_tail"] += l_k5
    track_c, fired_c, wall_c = kidnap_stream("cpu")
    tk = 300
    rec = track_g[tk]
    rec_pos = float(np.hypot(*(rec[:2] - gt_k[tk, :2])))
    rec_yaw = yaw_err(rec[2], gt_k[tk, 2])
    gap = float(np.abs(track_g - track_c).max())
    print(f"[15] (d) kidnap stream ({counts_k.shape[0]} steps x 541 rays, "
          f"PLICP, loss gate 0.3 m): loss gate fired at {fired_g} (CPU "
          f"{fired_c}); recovered {rec_pos:.4f} m, {rec_yaw:.4f} rad from "
          f"ground truth; final error "
          f"{float(np.hypot(*(track_g[-1, :2] - gt_k[-1, :2]))):.4f} m; card "
          f"{wall_g:.2f} s, CPU {wall_c:.2f} s; card vs CPU max pose diff "
          f"{gap:.3e}; launches raywalk_scan {l_scan}, nn_argmin {l_nn}, "
          f"icp_sweep_tail {l_k5} (the relocalization's polish)",
          flush=True)
    if fired_g != [tk] or fired_c != [tk]:
        fail("[15] (d) the loss gate did not fire at the kidnap step only")
    if rec_pos > RELOC_POS_TOL or rec_yaw > RELOC_YAW_TOL:
        fail("[15] (d) the kidnap was not recovered")
    if gap > SMALL_POSE_TOL:
        fail("[15] (d) card and CPU kidnap streams disagree")

    # (e) a small log, card against CPU, on one noise
    ds = io.synthetic_dataset(**SMALL_PF)
    ms = MapConfig(resolution=0.1, world_max_x=15, world_min_x=-15,
                   world_max_y=15, world_min_y=-15)
    P, ns = 64, SMALL_PF["n_steps"]
    gen = torch.Generator().manual_seed(0)
    noise = (torch.randn((ns - 1, P), generator=gen),
             torch.randn((ns - 1, P), generator=gen),
             torch.rand((ns - 1,), generator=gen))
    scfg = pf.PFConfig(n_particles=P)
    outs = []
    for device in (dev, "cpu"):
        ps, mks = scan_ops.scans_to_points(f32(ds["lidar"]["ranges"], device),
                                           0.1, 30.0, cfg.lidar)
        gts = f32(ds["ground_truth"], device)
        cs = f32(ds["encoder"]["counts"], device) * 1.15
        gs = f32(ds["imu"]["angular_velocity"], device)
        Ks = occupancy.adaptive_ray_cells(ps, mks, ms, 30.0)
        im_s = rl.hit_map(occupancy.build_logodds(gts, ps, mks, ms, Ks))
        loc = pf.localize_particle_filter(im_s, cs, gs, ps, mks, ms, scfg,
                                          x0=gts[0], noise=noise,
                                          device=device)
        sl = pf_slam.slam_particle_filter(cs, gs, ps, mks, ms, scfg,
                                          x0=gts[0], K=Ks, noise=noise,
                                          device=device)
        outs.append([t.cpu() for t in (loc[0], loc[1]["resampled"], sl[0],
                                       sl[1], sl[2]["resampled"], ps)])
    (lg, rg, sg, mg, srg, pg), (lc, rc, sc, mc, src, pc) = outs
    gaps = [float((a - b).abs().max()) for a, b in ((lg, lc), (sg, sc),
                                                     (mg, mc))]
    flags = torch.equal(rg, rc) and torch.equal(srg, src)
    hits = torch.equal(mg > 0, mc > 0)
    print(f"[15] (e) small log ({ns} x {SMALL_PF['n_rays']}, {P} particles) "
          f"card vs CPU on one noise (points computed on each, equal "
          f"{torch.equal(pg, pc)}): localization track "
          f"max diff {gaps[0]:.3e}, PF-SLAM track {gaps[1]:.3e}, map "
          f"{gaps[2]:.3e}; "
          f"resample flags equal {flags} ({int(rg.sum())} and "
          f"{int(srg.sum())} resamples); hit maps equal {hits}", flush=True)
    if (max(gaps) > SMALL_PF_TOL or not flags or not hits
            or not torch.equal(pg, pc)):
        fail("[15] (e) the card's particle filters disagree with the CPU's")
    return launches, nn_r, k5_r, dev_k5


WARMUP_SEEDS, WARMUP_BATCH = 24, 8  # [16]: warmup_icp.py --synthetic
WARMUP_CLOUDS = 4  # [16] (a): synthetic_pc(model, i) for i < 4
# [16] (a): the clouds where the reference's stopping rule (|delta
# normalized error| < 1e-4) ends the sweep more than 0.05 from the applied
# rotation, in the JAX package too (tests/test_torch_warmup.py::
# test_warmup_stopping_rule_misses_like_jax; 0.0917 in the port on the
# CPU): held to the CPU's sweep in place of the ground truth
WARMUP_STOP_MISSES = (1,)
WARMUP_ROT_TOL = 0.05  # tests/test_correlation_voxel_warmup.py:129
# [16] (a): the CPU sweeps' translations were within 0.00096 m of the
# applied one (5,000 points, clouds 0-3)
WARMUP_TRANS_TOL = 0.002
# [16] (b), (d): card against CPU; the CPU parity tests found every seed's
# iteration count equal to JAX's and the transforms within 5.4e-7
WARMUP_CARD_CPU_TOL = 1e-5
WARMUP_SMALL = 800  # [16] (b): points of the card-vs-CPU model


def icp_syncs(src, tgt, T0, planar: bool) -> int:
    """Host synchronizations of one ICP iteration (the kernel, the fit and
    the error) on the card, counted by torch's sync debug mode."""
    import warnings

    from lidar_slam_tpu_torch.ops import icp as icp_ops

    B = src.shape[0]
    ones = [torch.ones(a.shape[:2], dtype=torch.bool, device=a.device)
            for a in (src, tgt)]
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            icp_ops.icp_iteration(src, tgt, *ones, T0[:B], True,
                                  planar=planar)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in seen)


def warmup_phase(dev) -> dict:
    """[16]: the ICP warm-up on the card (models/warmup.py: 24 yaw seeds of
    non-planar 3-D ICP in batches of 8, the NN kernel at D = 3). (a) the
    synthetic 5,000-point model against synthetic_pc(model, i), i < 4, as
    `warmup_icp.py --synthetic` runs it, K4's counter reset just before
    each sweep: seconds, iterations a seed, best error, K4 launches; the
    best transform within WARMUP_ROT_TOL (rotation) and WARMUP_TRANS_TOL
    (translation) of the applied one, or for WARMUP_STOP_MISSES within
    WARMUP_CARD_CPU_TOL of the CPU's sweep; the host syncs of one
    non-planar and one planar ICP iteration. (b) an 800-point model's
    sweep on the card and the CPU: the same best seed, every seed's
    iteration count equal, the best transform within WARMUP_CARD_CPU_TOL.
    (c) K4 on (a)'s first iteration of the first seed batch (8 x 5,000 x
    ~3,500, D = 3, past one 2,048-target stage): nn_check. (d)
    test_warmup_downsample_trigger's 25,000-point clouds through
    voxel_downsample on the card: the JAX test's translation gate and the
    CPU's transform within WARMUP_CARD_CPU_TOL. (e) `python -m
    lidar_slam_tpu_torch.warmup_icp --synthetic --num_pc 4` on the card
    and with --device cpu: the same "Best errors" block. Returns the
    launches and nn_check's numbers."""
    from lidar_slam_tpu_torch.kernels.icp import icp_sweep_tail
    from lidar_slam_tpu_torch.kernels.nn import nn_argmin
    from lidar_slam_tpu_torch.models import warmup
    from lidar_slam_tpu_torch.ops import icp as icp_ops

    model = warmup.synthetic_model()
    launches, first = 0, None
    for i in range(WARMUP_CLOUDS):
        tgt = warmup.synthetic_pc(model, i)
        G = warmup.synthetic_pose(model, i)
        torch.cuda.synchronize()
        nn_argmin.launches = icp_sweep_tail.launches = 0
        t0 = time.perf_counter()
        T, err, errs, iters = warmup.best_icp_alignment(
            model, tgt, n_seeds=WARMUP_SEEDS, seed_batch=WARMUP_BATCH,
            device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n_k4 = nn_argmin.launches
        launches += n_k4
        rot = float(np.abs(T[:3, :3] - G[:3, :3]).max())
        trans = float(np.abs(T[:3, 3] - G[:3, 3]).max())
        print(f"[16] (a) cloud {i}: {model.shape[0]} x {tgt.shape[0]} "
              f"points, {WARMUP_SEEDS} seeds in batches of {WARMUP_BATCH}: "
              f"{secs:.3f} s; ICP iterations a seed {iters.tolist()}; best "
              f"seed {int(np.argmin(errs))}, error {err:.6e}; K4 launches "
              f"{n_k4}; off the applied transform: rotation {rot:.4f}, "
              f"translation {trans:.5f} m", flush=True)
        if n_k4 == 0:
            fail(f"[16] (a) cloud {i}: nn_argmin was not launched")
        if icp_sweep_tail.launches:
            fail(f"[16] (a) cloud {i}: the 3-D fit took the fused sweep")
        if not np.isfinite(T).all() or trans > WARMUP_TRANS_TOL:
            fail(f"[16] (a) cloud {i}: translation {trans} off the applied "
                 f"one (gate {WARMUP_TRANS_TOL})")
        if i in WARMUP_STOP_MISSES:
            T_c, _, errs_c, _ = warmup.best_icp_alignment(
                model, tgt, n_seeds=WARMUP_SEEDS, seed_batch=WARMUP_BATCH,
                device="cpu")
            gap = float(np.abs(T - T_c).max())
            print(f"[16] (a) cloud {i} (the reference's stop misses it in "
                  f"the JAX package too): best seed card "
                  f"{int(np.argmin(errs))}, CPU {int(np.argmin(errs_c))}; "
                  f"transform card vs CPU {gap:.3e}", flush=True)
            if gap > WARMUP_CARD_CPU_TOL:
                fail(f"[16] (a) cloud {i}: the card's transform differs "
                     f"from the CPU's")
        elif rot > WARMUP_ROT_TOL:
            fail(f"[16] (a) cloud {i}: rotation {rot} off the applied one")
        if first is None:
            first = tgt
    # the fit's host syncs: torch.linalg.svd on CUDA tensors checks its
    # convergence on the host
    s3 = torch.as_tensor(model, dtype=torch.float32, device=dev)
    t3 = torch.as_tensor(first, dtype=torch.float32, device=dev)
    seeds = torch.as_tensor(warmup.yaw_seed_transforms(
        model, first, WARMUP_SEEDS)[:WARMUP_BATCH], dtype=torch.float32,
        device=dev)
    src_b = s3.expand(WARMUP_BATCH, -1, -1).contiguous()
    tgt_b = t3.expand(WARMUP_BATCH, -1, -1).contiguous()
    syncs = {p: icp_syncs(src_b, tgt_b, seeds, p) for p in (False, True)}
    print(f"[16] (a) host syncs of one ICP iteration of {WARMUP_BATCH} "
          f"seeds (torch.cuda.set_sync_debug_mode): non-planar (3-D SVD "
          f"Kabsch) {syncs[False]}, planar (closed form) {syncs[True]}",
          flush=True)

    # (b) card against CPU on a smaller model
    small = warmup.synthetic_model(WARMUP_SMALL)
    for i in range(WARMUP_CLOUDS):
        tgt = warmup.synthetic_pc(small, i)
        res = [warmup.best_icp_alignment(small, tgt, device=d)
               for d in (dev, "cpu")]
        (T_g, _, e_g, it_g), (T_c, _, e_c, it_c) = res
        gap = float(np.abs(T_g - T_c).max())
        n_it = int((it_g != it_c).sum())
        print(f"[16] (b) {WARMUP_SMALL}-point model, cloud {i}: best seed "
              f"card {int(np.argmin(e_g))}, CPU {int(np.argmin(e_c))}; "
              f"seeds with another iteration count {n_it}; best transform "
              f"card vs CPU {gap:.3e}; errors "
              f"{float(np.abs(e_g - e_c).max()):.3e} apart", flush=True)
        if (int(np.argmin(e_g)) != int(np.argmin(e_c)) or n_it
                or gap > WARMUP_CARD_CPU_TOL):
            fail(f"[16] (b) cloud {i}: the card's sweep differs from the "
                 f"CPU's")

    # (c) K4 on the first iteration of the first seed batch
    src_t = icp_ops._transform(src_b, seeds)
    tm = torch.ones(tgt_b.shape[:2], dtype=torch.bool, device=dev)
    nn_w = nn_check(src_t, tgt_b, tm, 20)
    dev_ms = device_ms(lambda: nn_argmin(src_t, tgt_b, tm), 20,
                       "nn_argmin_kernel")
    print(f"[16] (c) nn_argmin on the warm-up's first iteration, "
          f"{' x '.join(map(str, (*src_t.shape[:2], tgt_b.shape[1])))}, "
          f"D = 3: {NN_EXACT}; vs plain: index flips {nn_w[0]:.5f}, max "
          f"chosen-distance gap {nn_w[1]:.3e}; kernel {nn_w[2]:.4f} ms "
          f"(device {fmt(dev_ms)}), plain {nn_w[3]:.4f} ms, torch.cdist + "
          f"argmin {nn_w[4]:.4f} ms; bound {nn_w[5][0]:.5f} ms "
          f"({nn_w[5][1]})", flush=True)

    # (d) the voxel-downsampled sweep
    rng = np.random.default_rng(4)
    src = rng.normal(0, 0.1, (25000, 3))
    tgt = src + np.array([0.05, 0.0, 0.0])
    kw = dict(n_seeds=2, downsample_above=20000, voxel_size=0.05,
              seed_batch=2)
    nn_argmin.launches = 0
    T_g, e_g, _, _ = warmup.best_icp_alignment(src, tgt, device=dev, **kw)
    n_k4 = nn_argmin.launches
    T_c, _, _, _ = warmup.best_icp_alignment(src, tgt, device="cpu", **kw)
    kept = warmup.voxel_downsample(src, 0.05).shape[0]
    off = float(np.abs(T_g[:3, 3] - [0.05, 0.0, 0.0]).max())
    gap = float(np.abs(T_g - T_c).max())
    print(f"[16] (d) 25000-point clouds, voxel_downsample at 0.05 m to "
          f"{kept} points: error {e_g:.6e}, translation {off:.5f} m off "
          f"[0.05, 0, 0] (gate 0.02); card vs CPU {gap:.3e}; K4 launches "
          f"{n_k4}", flush=True)
    if not np.isfinite(e_g) or off > 0.02 or gap > WARMUP_CARD_CPU_TOL \
            or n_k4 == 0:
        fail("[16] (d) the downsampled sweep failed")

    # (e) the CLI on the card and on the CPU
    blocks = {}
    for d in (dev.type, "cpu"):
        cwd = os.path.join(ROOT, "build", "warmup_cli", d)
        os.makedirs(cwd, exist_ok=True)
        env = dict(os.environ, PYTHONPATH=ROOT)
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "lidar_slam_tpu_torch.warmup_icp",
             "--synthetic", "--num_pc", str(WARMUP_CLOUDS), "--device", d],
            capture_output=True, text=True, cwd=cwd, env=env, timeout=600)
        if out.returncode != 0:
            fail(f"[16] (e) warmup_icp --device {d} exited "
                 f"{out.returncode}:\n{out.stderr[-2000:]}")
        lines = out.stdout.splitlines()
        blocks[d] = lines[lines.index("Best errors:"):]
        print(f"[16] (e) python -m lidar_slam_tpu_torch.warmup_icp "
              f"--synthetic --num_pc {WARMUP_CLOUDS} --device {d}: "
              f"{time.perf_counter() - t0:.1f} s; "
              f"{' | '.join(blocks[d])}", flush=True)
    if blocks[dev.type] != blocks["cpu"] or len(blocks["cpu"]) != \
            WARMUP_CLOUDS + 1:
        fail("[16] (e) the CLI's best errors on the card differ from the "
             "CPU's")
    return {"launches": launches, "nn": nn_w, "device_ms": dev_ms,
            "syncs": syncs}


SHARDED_RANKS = 4  # [17]: gloo ranks sharing the card
# [17] (a): scans padded to a multiple of 8, as JAX's dataset-scale test
# pads for its 8 devices (4,956 -> 4,960), so all-masked identity scans
# run on the card too
SCAN_PAD = 8
SHARDED_MAP_TOL = 1e-4  # [17] (a), (b), (d): the JAX tests' map bound
SHARDED_POSE_TOL, SHARDED_COST_RTOL = 2e-5, 1e-6  # [17] (c)
STEP_TOL = 1e-6  # [17] (d): tests/test_superstep_goldens.py's bound
FULL_WIDTH_TOL = 3e-3  # [17] (d), (g): the port's full-width ICP bound
# (tests/test_torch_ops.py::test_scan_matching_full_width_bound)
BLOCK_TOL = 1e-6  # [17] (g): a rank's block against the block run alone
WINDOW, RAY_SCANS, PF_STEPS, TEX_FRAMES = 64, 256, 500, 64
PF_LOG_STEPS = 4956  # [17] (e): [15]'s log
# [17] (e): the online CLI's relocalization budget on the 60 x 60 m map
SHARDED_RELOC = dict(search_radius=0.5 * float(np.hypot(60.0, 60.0)),
                     beam=4096, n_angles=360, max_rays=256)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rank_stats(world, mesh, wall: float, k2: int, k4: int, k5: int) -> list:
    """Every rank's [wall s, collective s, bytes, collectives, K2, K4 and
    K5 launches] of the sub-phase that just ran on `mesh`, gathered over
    the 1-D mesh `world` after it."""
    from lidar_slam_tpu_torch.parallel.mesh import all_gather

    mine = torch.tensor([wall, mesh.seconds, mesh.bytes, mesh.calls, k2,
                         k4, k5], dtype=torch.float64, device=mesh.device)
    return all_gather(mine, world, "dp").tolist()


def sharded_ranks(device, inp: dict) -> dict:
    """[17]'s rank program: the sub-phases in inp["phases"], each timed on
    the host clock to a synchronize, with the mesh's collective counters
    and K2's, K4's and K5's launch counters reset just before it; the launches
    of the comparisons a rank makes itself ((g)'s block run alone) are
    not counted. Returns, on every rank, each sub-phase's result and
    every rank's stats."""
    import torch.distributed as dist

    from lidar_slam_tpu_torch.config import (IcpConfig, PoseGraphConfig,
                                             SlamConfig)
    from lidar_slam_tpu_torch.kernels.icp import icp_sweep_tail
    from lidar_slam_tpu_torch.kernels.nn import nn_argmin
    from lidar_slam_tpu_torch.kernels.raywalk import raywalk_scan
    from lidar_slam_tpu_torch.models import particle_filter as pf
    from lidar_slam_tpu_torch.models import relocalization as rl
    from lidar_slam_tpu_torch.models.scan_matching import pad_pairs
    from lidar_slam_tpu_torch.ops import icp as icp_ops
    from lidar_slam_tpu_torch.ops import scan as scan_ops
    from lidar_slam_tpu_torch.parallel import sharding
    from lidar_slam_tpu_torch.parallel.mesh import all_gather, make_mesh
    from lidar_slam_tpu_torch.parallel.superstep import make_slam_step
    from lidar_slam_tpu_torch.utils import se2

    cfg = SlamConfig()
    m1 = make_mesh(device=device.type)
    D = m1.size("dp")
    f = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        a, dtype=dt, device=device)
    out = {"backend": m1.backend, "world": dist.get_world_size(),
           "cards": torch.cuda.device_count()}

    def timed(tag, mesh, fn):
        _sync(device)
        raywalk_scan.launches = nn_argmin.launches = 0
        icp_sweep_tail.launches = 0
        mesh.reset_counters()
        t0 = time.perf_counter()
        result = fn()
        _sync(device)
        wall = time.perf_counter() - t0
        k2, k4 = raywalk_scan.launches, nn_argmin.launches
        out[tag] = result
        out[f"{tag}_stats"] = _rank_stats(m1, mesh, wall, k2, k4,
                                          icp_sweep_tail.launches)
        return result

    a = inp.get("a")
    if a is not None:
        pts, masks = scan_ops.scans_to_points(f(a["ranges"]), 0.1, 30.0,
                                              cfg.lidar)
        gt = f(a["gt"])
    if "a" in inp["phases"]:
        p_, m_, g_ = (sharding.pad_batch(x, SCAN_PAD, pad_value=v)[0]
                      for x, v in ((pts, 0), (masks, False), (gt, 0)))
        build = sharding.sharded_build_logodds_scans(m1, cfg.map, a["K"])
        timed("a", m1, lambda: build(g_, p_, m_).cpu())
    if "b" in inp["phases"]:
        n = inp["b"]["scans"]
        p_ = sharding.pad_batch(pts[:n], D, axis=1)[0]
        m_ = sharding.pad_batch(masks[:n], D, axis=1, pad_value=False)[0]
        build = sharding.sharded_build_logodds(m1, cfg.map, a["K"])
        timed("b", m1, lambda: build(gt[:n], p_, m_).cpu())
    if "c" in inp["phases"]:
        c = inp["c"]
        pg_cfg = PoseGraphConfig(**c["cfg"])
        run = sharding.sharded_optimize_trajectory(m1, pg_cfg)
        li, lj, mask = (f(c[k], None) for k in ("li", "lj", "mask"))
        for dt, tag in ((torch.float64, "c"), (torch.float32, "c32")):
            args = (f(c["x0"], dt), f(c["rel"], dt), li, lj,
                    f(c["meas"], dt), mask)
            timed(tag, m1, lambda: run(*args))
        wide, live = lj.clone(), mask.clone()
        wide[0] += 5 * pg_cfg.fixed_interval
        live[0] = True
        try:
            run(f(c["x0"], torch.float64), f(c["rel"], torch.float64), li,
                wide, f(c["meas"], torch.float64), live)
            out["c_guard"] = ""
        except ValueError as err:
            out["c_guard"] = str(err)
    if "d" in inp["phases"]:
        d = inp["d"]
        m2 = make_mesh(axes=("dp", "rp"), device=device.type)
        step = make_slam_step(m2, cfg.map, a["K"], IcpConfig(),
                              PoseGraphConfig(max_lm_iters=3))
        args = (f(d["points"]), f(d["masks"], torch.bool), f(d["odom"]),
                torch.zeros((cfg.map.width, cfg.map.height), device=device))
        timed("d", m2, lambda: step(*args))
        # the step's ICP iterations, for the near-tie exception
        pts_w, msk_w, odom = args[:3]
        seeds = se2.TSE3_from_TSE2(se2.get_relative_pose(odom[:-1],
                                                         odom[1:]))
        icp = IcpConfig()
        res = sharding.sharded_icp_batch(m2, "dp")(
            *pad_pairs(pts_w[1:], pts_w[:-1], msk_w[1:], msk_w[:-1], seeds,
                       m2.size("dp")), epsilon=icp.epsilon,
            max_iters=icp.max_iters, stopping_thresh=icp.stopping_thresh,
            planar=True)
        out["d_iters"] = res.iters[:pts_w.shape[0] - 1].cpu()
    if "e" in inp["phases"]:
        e = inp["e"]
        m = e["map"]
        pcfg = pf.PFConfig(n_particles=e["particles"])
        p_e, m_e = scan_ops.scans_to_points(f(e["ranges"]), 0.1, 30.0,
                                            cfg.lidar)
        score = sharding.sharded_pf_score(m1, m)
        timed("e_pf", m1, lambda: pf.localize_particle_filter(
            f(e["im"]), f(e["counts"]), f(e["gyro"]), p_e, m_e, m, pcfg,
            x0=f(e["x0"]), score_fn=score,
            noise=tuple(map(f, e["noise"])), device=device))
        rcfg = rl.RelocConfig(**e["reloc_cfg"])
        nodes = sharding.sharded_reloc_score(m1)
        timed("e_reloc", m1, lambda: rl.relocalize(
            f(e["hit"]), m, f(e["reloc_pts"]),
            f(e["reloc_mask"], torch.bool), rcfg, score_fn=nodes))
    if "f" in inp["phases"]:
        poses_t, disp, rgb = texture_batch(inp["f"]["frames"])
        B = disp.shape[0]
        paint = sharding.sharded_texture_paint(m1, cfg.map, cfg.camera)
        cells = cfg.map.width * cfg.map.height
        carry = lambda: (torch.full((cells,), -1, dtype=torch.int32,  # noqa
                                    device=device),
                         torch.zeros(cells, dtype=torch.int32,
                                     device=device))
        timed("f_frames", m1, lambda: tuple(x.cpu() for x in paint(
            *carry(), f(disp), torch.as_tensor(rgb, device=device),
            f(poses_t), torch.ones(B, dtype=torch.bool, device=device), 0)))
        ops = torch.as_tensor(inp["f"]["ops"], device=device)
        paint_ops = sharding.sharded_paint_ops(m1, cfg.map)
        timed("f_ops", m1, lambda: tuple(
            x.cpu() for x in paint_ops(*carry(), ops, 0)))
    if "g" in inp["phases"]:
        g = inp["g"]
        p3, m3 = scan_ops.scans_to_points(f(g["ranges"]), 0.1, 30.0,
                                          cfg.lidar)
        p3 = icp_ops.lift_to_3d(p3)
        odo = f(g["odom"])
        seeds = se2.TSE3_from_TSE2(se2.get_relative_pose(odo[:-1], odo[1:]))
        pairs = pad_pairs(p3[1:], p3[:-1], m3[1:], m3[:-1], seeds, D)
        kw = dict(epsilon=cfg.icp.epsilon, max_iters=cfg.icp.max_iters,
                  stopping_thresh=cfg.icp.stopping_thresh, planar=True)
        icp = sharding.sharded_icp_batch(m1)
        res = timed("g", m1, lambda: icp(*pairs, **kw))
        out["g"] = tuple(x.cpu() for x in res[:3])
        # this rank's block run alone on the card (not counted)
        b = pairs[0].shape[0] // D
        r = m1.index("dp")
        sl = slice(r * b, (r + 1) * b)
        alone = icp_ops.run_icp_batch(*(x[sl] for x in pairs), **kw)
        mine = torch.tensor(
            [float((alone.T - res.T[sl]).abs().max()),
             float((alone.iters != res.iters[sl]).sum())],
            dtype=torch.float64, device=device)
        out["g_blocks"] = all_gather(mine, m1, "dp").tolist()
    return out


def texture_batch(n: int):
    """(poses (n, 3), disp (n, H, W) float32, rgb) of texture_frames()'s
    first n frames, loaded 16 at a time as [13] loads them."""
    poses, loader = texture_frames()
    disp, rgb = zip(*(loader(np.arange(s, min(s + 16, n)))
                      for s in range(0, n, 16)))
    return (poses[:n], np.concatenate(disp).astype(np.float32),
            np.concatenate(rgb))


def sharded_phase(dev, cfg, d20, res5, log21, pts21, masks21) -> dict:
    """[17]: the multi-rank layer on the card. One run of sharded_ranks on
    SHARDED_RANKS gloo ranks sharing the card does (a)-(g); (a) runs again
    in one rank on NCCL; (h) is dryrun_multichip(4). Every rank computes
    on the card; the single-device oracles run here, on the card. Gates:
    (a) the scan-sharded map of the seed-20 log (4,956 scans padded to
    4,960) against raywalk_build within 1e-4, finalize_grid equal; (b)
    the ray-sharded map of its first 256 scans (1,081 rays padded to
    1,084) likewise; (c) the factor-sharded LM on [5]'s graph in float64
    against the banded optimize (poses 2e-5, cost 1e-6 relative,
    iterations within one; float32 printed), and a wide live arc raises;
    (d) the superstep on a 64-scan window at full width (1,082 rays) on
    the (2, 2) mesh against the unsharded composition (poses and ICP
    errors 1e-6, or 3e-3 where an NN near-tie changed a pair's
    iterations; log-odds 1e-4, finalized grids equal); (e) PF
    localization (256 particles, 500 steps) and one relocalization at the
    CLI's budget with sharded scorers, bit-equal to the single-device
    runs; (f) 64 texture frames and their native paint ops, bit-equal to
    paint_cells and paint_ops; (g) [5]'s 4,955 ICP pairs (padded to
    4,956): each rank's block equal to the block run alone (iterations,
    T within 1e-6), T within 3e-3 of [5]'s scan matching, K4's indices
    equal to nn_argmin_rounded. Returns K2's and K4's launches over the
    ranks."""
    import dataclasses

    from lidar_slam_tpu_torch.config import (IcpConfig, MapConfig,
                                             PoseGraphConfig)
    from lidar_slam_tpu_torch.kernels.raywalk import raywalk_build
    from lidar_slam_tpu_torch.models import (occupancy, odometry,
                                             particle_filter, pose_graph,
                                             relocalization, slam, texture)
    from lidar_slam_tpu_torch.ops import icp as icp_ops
    from lidar_slam_tpu_torch.ops import scan as scan_ops
    from lidar_slam_tpu_torch.parallel import dryrun, launch
    from lidar_slam_tpu_torch.parallel.mesh import pick_backend
    from lidar_slam_tpu_torch.utils import io, native, se2

    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,  # noqa
                                    device=dev)
    gt20 = np.asarray(d20["ground_truth"], np.float32)
    ranges20 = np.asarray(d20["lidar"]["ranges"], np.float32)
    pts20, masks20 = scan_ops.scans_to_points(f32(ranges20), 0.1, 30.0,
                                              cfg.lidar)
    K = occupancy.adaptive_ray_cells(pts20, masks20, cfg.map, 30.0)
    inp = {"a": dict(ranges=ranges20, gt=gt20, K=K),
           "b": dict(scans=RAY_SCANS)}

    # (c) [5]'s fixed-interval graph, loops verified as run_slam does
    counts21, gyro21 = (f32(x) for x in log21[:2])
    md, my = odometry.max_step_gates(counts21, gyro21, cfg.robot.dt)
    cand = slam.loop_closure_candidates(pts21.shape[0], 10)
    loop_T, accept, _, _ = slam.compute_loop_closures(
        icp_ops.lift_to_3d(pts21), masks21, cand, 10, float(md), float(my))
    pg_cfg = dataclasses.replace(cfg.pose_graph, solver="banded",
                                 fixed_interval=10)
    inp["c"] = dict(x0=res5.poses_scan_matching.astype(np.float64),
                    rel=res5.relative_poses_scan_matching.astype(np.float64),
                    li=cand, lj=cand + 10, meas=loop_T.double().cpu().numpy(),
                    mask=accept.cpu().numpy(),
                    cfg=dataclasses.asdict(pg_cfg))

    # (d) a 64-scan window of (a)'s log, 1,081 rays padded to 1,082
    d_pts = torch.nn.functional.pad(icp_ops.lift_to_3d(pts20[:WINDOW]),
                                    (0, 0, 0, 1))
    d_masks = torch.nn.functional.pad(masks20[:WINDOW], (0, 1))
    odom20 = odometry.poses_from_odometry(
        f32(d20["encoder"]["counts"][:WINDOW]),
        f32(d20["imu"]["angular_velocity"][:WINDOW]), x_0=f32(gt20[0]))
    inp["d"] = dict(points=d_pts.cpu().numpy(), masks=d_masks.cpu().numpy(),
                    odom=odom20.cpu().numpy())

    # (e) [15] (a)'s localization run, first PF_STEPS steps; [15] (c)'s
    # relocalization of scan RELOC_GATED_SCAN on its log's map
    m = MapConfig.from_cli(0.05, 60, 60)
    Km = occupancy.max_ray_cells(m, 30.0)
    d21 = io.synthetic_dataset(n_steps=PF_LOG_STEPS, n_rays=1081, seed=21)
    gt21 = f32(d21["ground_truth"])
    p21, mk21 = scan_ops.scans_to_points(f32(d21["lidar"]["ranges"]), 0.1,
                                         30.0, cfg.lidar)
    im = relocalization.hit_map(occupancy.build_logodds(gt21, p21, mk21, m,
                                                        Km))
    d_s = io.synthetic_dataset(n_steps=RELOC_GATED_STEPS, n_rays=1081,
                               seed=21)
    p_s, mk_s = scan_ops.scans_to_points(f32(d_s["lidar"]["ranges"]), 0.1,
                                         30.0, cfg.lidar)
    hit_s = relocalization.hit_map(occupancy.build_logodds(
        f32(d_s["ground_truth"]), p_s, mk_s, m, Km))
    rng = np.random.default_rng(17)
    n_e = PF_STEPS
    noise = (rng.standard_normal((n_e - 1, PF_PARTICLES)).astype(np.float32),
             rng.standard_normal((n_e - 1, PF_PARTICLES)).astype(np.float32),
             rng.random(n_e - 1).astype(np.float32))
    k = RELOC_GATED_SCAN
    inp["e"] = dict(
        map=m, particles=PF_PARTICLES,
        ranges=np.asarray(d21["lidar"]["ranges"][:n_e], np.float32),
        counts=np.asarray(d21["encoder"]["counts"][:n_e], np.float32) * 1.15,
        gyro=np.asarray(d21["imu"]["angular_velocity"][:n_e], np.float32),
        x0=np.asarray(d21["ground_truth"][0], np.float32), noise=noise,
        im=im.cpu().numpy(), hit=hit_s.cpu().numpy(),
        reloc_pts=p_s[k].cpu().numpy(), reloc_mask=mk_s[k].cpu().numpy(),
        reloc_cfg=SHARDED_RELOC)

    # (f) the first TEX_FRAMES of [13]'s frames and their native ops
    poses_t, disp, rgb = texture_batch(TEX_FRAMES)
    op_cells, op_colors = native.project_frames(
        disp.astype(np.uint16), rgb, poses_t.astype(np.float64), cfg.camera,
        cfg.map)
    inp["f"] = dict(frames=TEX_FRAMES, ops=texture._pad_paint_ops(
        op_cells, op_colors, multiple_of=SHARDED_RANKS))

    # (g) [5]'s consecutive pairs, seeded by its odometry
    inp["g"] = dict(ranges=np.asarray(log21[2], np.float32),
                    odom=res5.poses_odom)
    inp["phases"] = ("a", "b", "c", "d", "e", "f", "g")

    def head(tag, r):
        return (f"[17] {tag} ({r['backend']}, world size {r['world']}, "
                f"{r['cards']} card(s))")

    def stats(s):
        s = np.asarray(s)
        return (f"wall {s[:, 0].max():.3f} s; collectives {s[0, 3]:.0f} a "
                f"rank, {s[:, 1].max():.3f} s, {s[0, 2]:,.0f} bytes a rank;"
                f" K2 launches a rank {s[:, 4].astype(int).tolist()}, K4 "
                f"{s[:, 5].astype(int).tolist()}, K5 "
                f"{s[:, 6].astype(int).tolist()}")

    t0 = time.perf_counter()
    r = launch.run_ranks(sharded_ranks, SHARDED_RANKS, None, dev.type, inp)
    print(f"[17] {SHARDED_RANKS} ranks spawned and run in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    columns = {"raywalk_scan": 4, "nn_argmin": 5, "icp_sweep_tail": 6}
    launches = dict.fromkeys(columns, 0)
    for key, val in r.items():
        if key.endswith("_stats"):
            for name, col in columns.items():
                launches[name] += int(np.asarray(val)[:, col].sum())

    # (a) against K1's whole build
    ref_a = raywalk_build(occupancy.ray_ends(f32(gt20), pts20, cfg.map),
                          masks20, cfg.map, K).cpu()
    diff_a = float((r["a"] - ref_a).abs().max())
    same_a = torch.equal(occupancy.finalize_grid(r["a"]),
                         occupancy.finalize_grid(ref_a))
    sat = int((ref_a.abs() >= cfg.map.logodds_clip).sum())
    n20 = gt20.shape[0]
    print(f"{head('(a) scan-sharded map', r)}, {ref_a.shape[0]} x "
          f"{ref_a.shape[1]}, {n20} scans padded to "
          f"{-(-n20 // SCAN_PAD) * SCAN_PAD}, K={K}: max |diff| "
          f"against raywalk_build {diff_a:.3e}, finalize_grid equal "
          f"{same_a}, saturated cells {sat}; {stats(r['a_stats'])}",
          flush=True)
    if diff_a > SHARDED_MAP_TOL or not same_a or sat == 0:
        fail("[17] (a) the scan-sharded map disagrees with raywalk_build")
    t0 = time.perf_counter()
    r1 = launch.run_ranks(sharded_ranks, 1, None, dev.type,
                          dict(a=inp["a"], phases=("a",)))
    diff_1 = float((r1["a"] - ref_a).abs().max())
    same_1 = torch.equal(occupancy.finalize_grid(r1["a"]),
                         occupancy.finalize_grid(ref_a))
    print(f"{head('(a) repeated', r1)}: max |diff| against raywalk_build "
          f"{diff_1:.3e}, finalize_grid equal {same_1}; against the "
          f"{SHARDED_RANKS}-rank map "
          f"{float((r1['a'] - r['a']).abs().max()):.3e}; "
          f"{stats(r1['a_stats'])}; spawned and run in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if (r1["backend"] != pick_backend(1, dev)
            or diff_1 > SHARDED_MAP_TOL or not same_1):
        fail("[17] (a) the one-rank NCCL map disagrees with raywalk_build")
    for name, col in columns.items():
        launches[name] += int(np.asarray(r1["a_stats"])[:, col].sum())

    # (b) the ray split against K1 on the same scans
    n = RAY_SCANS
    ref_b = raywalk_build(
        occupancy.ray_ends(f32(gt20[:n]), pts20[:n], cfg.map),
        masks20[:n].contiguous(), cfg.map, K).cpu()
    diff_b = float((r["b"] - ref_b).abs().max())
    same_b = torch.equal(occupancy.finalize_grid(r["b"]),
                         occupancy.finalize_grid(ref_b))
    print(f"{head('(b) ray-sharded map', r)}, {n} scans x 1,081 rays padded "
          f"to 1,084: max |diff| against raywalk_build {diff_b:.3e}, "
          f"finalize_grid equal {same_b}; {stats(r['b_stats'])}", flush=True)
    if diff_b > SHARDED_MAP_TOL or not same_b:
        fail("[17] (b) the ray-sharded map disagrees with raywalk_build")

    # (c) the factor-sharded LM against the banded optimize
    c = inp["c"]
    gaps = {}
    for dt, tag in ((torch.float64, "c"), (torch.float32, "c32")):
        ref = pose_graph.optimize_trajectory(
            *(torch.as_tensor(c[k], device=dev).to(dt)
              for k in ("x0", "rel")),
            torch.as_tensor(c["li"], device=dev),
            torch.as_tensor(c["lj"], device=dev),
            torch.as_tensor(c["meas"], device=dev).to(dt),
            torch.as_tensor(c["mask"], device=dev), pg_cfg)
        got = r[tag]
        gaps[tag] = (float((got.poses - ref.poses.cpu()).abs().max()),
                     abs(float(got.cost) - float(ref.cost))
                     / abs(float(ref.cost)), got.iterations, ref.iterations)
        print(f"{head('(c) factor-sharded LM', r)} on [5]'s graph in "
              f"{str(dt)[6:]} ({c['x0'].shape[0]} poses, "
              f"{int(c['mask'].sum())}/{len(c['mask'])} loops live): "
              f"iterations {got.iterations} (banded {ref.iterations}), cost "
              f"{float(got.cost):.9g} (banded {float(ref.cost):.9g}); max "
              f"pose diff {gaps[tag][0]:.3e}, cost rel diff "
              f"{gaps[tag][1]:.3e}" + ("" if tag == "c" else " (printed, "
                                       "not gated: [14] (d))")
              + f"; {stats(r[f'{tag}_stats'])}", flush=True)
    g64 = gaps["c"]
    if (g64[0] > SHARDED_POSE_TOL or g64[1] > SHARDED_COST_RTOL
            or abs(g64[2] - g64[3]) > 1):
        fail("[17] (c) the factor-sharded LM disagrees with the banded "
             "solve")
    print(f"[17] (c) guard, a live arc 60 poses wide: {r['c_guard']!r}",
          flush=True)
    if "banded-only" not in r["c_guard"]:
        fail("[17] (c) the wide live arc did not raise")

    # (d) the superstep against the unsharded composition at its caps
    d = inp["d"]
    pts_w, msk_w, odom = (torch.as_tensor(d[k], device=dev)
                          for k in ("points", "masks", "odom"))
    icp = IcpConfig()
    pgc = PoseGraphConfig(max_lm_iters=3)
    seeds = se2.TSE3_from_TSE2(se2.get_relative_pose(odom[:-1], odom[1:]))
    res = icp_ops.run_icp_batch(pts_w[1:], pts_w[:-1], msk_w[1:],
                                msk_w[:-1], seeds, epsilon=icp.epsilon,
                                max_iters=icp.max_iters,
                                stopping_thresh=icp.stopping_thresh,
                                planar=True)
    rel2 = se2.TSE2_from_TSE3(res.T)
    poses0 = se2.pose_from_T(se2.compose_chain(rel2,
                                               se2.T_from_pose(odom[0])))
    graph = pose_graph.make_graph(rel2, pgc, prior_pose=odom[0])
    opt = pose_graph.optimize(poses0, graph, max_iters=pgc.max_lm_iters,
                              cg_iters=pgc.cg_iters,
                              lambda_init=pgc.lambda_init,
                              lambda_up=pgc.lambda_up,
                              lambda_down=pgc.lambda_down,
                              solver=pgc.solver)
    grid = occupancy.build_logodds(opt.poses, pts_w[..., :2], msk_w,
                                   cfg.map, K).cpu()
    got = r["d"]
    ties = torch.nonzero(r["d_iters"][:res.iters.numel()]
                         != res.iters.cpu()).flatten().tolist()
    tied = [(i, int(r["d_iters"][i]), int(res.iters[i])) for i in ties]
    tol = FULL_WIDTH_TOL if ties else STEP_TOL
    dp = float((got.poses - opt.poses.cpu()).abs().max())
    de = float((got.icp_errors - res.error.cpu()).abs().max())
    dg = float((got.logodds - grid).abs().max())
    same_d = torch.equal(occupancy.finalize_grid(got.logodds),
                         occupancy.finalize_grid(grid))
    print(f"{head('(d) superstep', r)}, (dp, rp) = (2, 2), {WINDOW} scans x "
          f"1,082 rays: max pose diff against the unsharded composition "
          f"{dp:.3e}, ICP error diff {de:.3e}, log-odds {dg:.3e}, finalized "
          f"grids equal {same_d}; pairs whose ICP iterations differ "
          f"(float32 NN near-ties; sharded, alone) {tied}, pose gate "
          f"{tol:g}; {stats(r['d_stats'])}", flush=True)
    if dp > tol or de > tol or dg > SHARDED_MAP_TOL or not same_d:
        fail("[17] (d) the superstep disagrees with the unsharded "
             "composition")

    # (e) the sharded scorers against the single-device runs
    e = inp["e"]
    p_e, m_e = scan_ops.scans_to_points(f32(e["ranges"]), 0.1, 30.0,
                                        cfg.lidar)
    want = particle_filter.localize_particle_filter(
        f32(e["im"]), f32(e["counts"]), f32(e["gyro"]), p_e, m_e, m,
        particle_filter.PFConfig(n_particles=PF_PARTICLES), x0=f32(e["x0"]),
        noise=tuple(map(f32, e["noise"])), device=dev)
    got = r["e_pf"]
    same_pf = (torch.equal(got[0], want[0].cpu())
               and torch.equal(got[1]["resampled"],
                               want[1]["resampled"].cpu()))
    rw = relocalization.relocalize(
        f32(e["hit"]), m, f32(e["reloc_pts"]),
        torch.as_tensor(e["reloc_mask"], device=dev),
        relocalization.RelocConfig(**e["reloc_cfg"]))
    same_rl = all(torch.equal(a_.cpu(), b_) for a_, b_ in
                  zip(rw, r["e_reloc"]))
    print(f"{head('(e) particle-sharded PF', r)}, {PF_STEPS} steps x "
          f"{PF_PARTICLES} particles: track and resample flags bit-equal "
          f"{same_pf} ({int(got[1]['resampled'].sum())} resamples); "
          f"{stats(r['e_pf_stats'])}", flush=True)
    print(f"{head('(e) node-sharded relocalization', r)}, scan "
          f"{RELOC_GATED_SCAN} at the CLI's budget: pose, score, certificate"
          f" and margin bit-equal {same_rl} (score "
          f"{float(r['e_reloc'].score):.0f}, certified "
          f"{bool(r['e_reloc'].certified)}); {stats(r['e_reloc_stats'])}",
          flush=True)
    if not (same_pf and same_rl):
        fail("[17] (e) a sharded scorer's run differs from the "
             "single-device run")

    # (f) the paints against paint_cells and paint_ops
    cells = cfg.map.width * cfg.map.height
    carry = lambda: (torch.full((cells,), -1, dtype=torch.int32,  # noqa
                                device=dev),
                     torch.zeros(cells, dtype=torch.int32, device=dev))
    lin, cols, _ = texture.frames_to_cells(f32(disp), torch.as_tensor(
        rgb, device=dev), f32(poses_t), cfg.map, cfg.camera)
    want_f = texture.paint_cells(*carry(), lin, cols, 0)
    want_o = texture.paint_ops(*carry(), torch.as_tensor(inp["f"]["ops"],
                                                         device=dev), 0)
    same_f = all(torch.equal(a_.cpu(), b_)
                 for a_, b_ in zip(want_f, r["f_frames"]))
    same_o = all(torch.equal(a_.cpu(), b_)
                 for a_, b_ in zip(want_o, r["f_ops"]))
    print(f"{head('(f) frame-sharded texture', r)}, {TEX_FRAMES} frames of "
          f"480 x 640: winner and colour bit-equal to paint_cells {same_f} "
          f"({int((r['f_frames'][0] >= 0).sum())} cells); "
          f"{stats(r['f_frames_stats'])}", flush=True)
    print(f"{head('(f) op-stream paint', r)}, {len(op_cells)} native ops "
          f"padded to {inp['f']['ops'].shape[1]}: bit-equal to paint_ops "
          f"{same_o}; {stats(r['f_ops_stats'])}", flush=True)
    if not (same_f and same_o) or int((r["f_frames"][0] >= 0).sum()) == 0:
        fail("[17] (f) a sharded paint differs from the sequential paint")

    # (g) the pair-sharded ICP against [5]'s chunks and its blocks alone
    T_g, err_g, it_g = (x[:pts21.shape[0] - 1] for x in r["g"])
    blocks = np.asarray(r["g_blocks"])
    rel_g = se2.TSE2_from_TSE3(T_g)
    gap_g = float((rel_g - torch.as_tensor(
        res5.relative_poses_scan_matching)).abs().max())
    other = int((it_g.numpy() != res5.scan_matching_iters).sum())
    src = icp_ops.lift_to_3d(pts21)
    moved = icp_ops._transform(src[1:65], T_g[:64].to(dev))
    flips, gap, *_ = nn_check(moved.contiguous(), src[:64].contiguous(),
                              masks21[:64].contiguous(), 5)
    print(f"{head('(g) pair-sharded ICP', r)}, {pts21.shape[0] - 1} pairs "
          f"padded to {pts21.shape[0]}: each rank's block against the block "
          f"run alone: max T diff {blocks[:, 0].tolist()}, pairs with other "
          f"iterations {blocks[:, 1].astype(int).tolist()}; against [5]'s "
          f"64-pair chunks: {other} pairs with another iteration count, "
          f"max T gap {gap_g:.3e} (gate {FULL_WIDTH_TOL:g}); K4 on the first"
          f" 64 pairs at the result: {NN_EXACT}, flips {flips:.5f}; "
          f"{stats(r['g_stats'])}", flush=True)
    if (blocks[:, 0].max() > BLOCK_TOL or blocks[:, 1].any()
            or gap_g > FULL_WIDTH_TOL):
        fail("[17] (g) the pair-sharded ICP disagrees")

    # (h) the counterpart of __graft_entry__.dryrun_multichip
    t0 = time.perf_counter()
    s = dryrun.dryrun_multichip(SHARDED_RANKS, dev.type)
    print(f"[17] (h) dryrun_multichip({SHARDED_RANKS}) on {dev.type}: "
          f"{time.perf_counter() - t0:.1f} s with the spawn", flush=True)
    if s["backend"] != "gloo" or not s["device"].startswith(dev.type):
        fail("[17] (h) the dry run did not run on the card")
    return launches


def k6_work(n: int, b: int, m: int, q: int):
    """(bytes, float64 operations) of one K6 solve of float32 inputs: A, O
    and R read once and X written; a multiply-add two operations, a b x b
    product or Gauss-Jordan inversion 2 b^3 (csrc/tridiag.cu's
    recurrences)."""
    from lidar_slam_tpu_torch.kernels.tridiag import segments

    qs, B = segments(n, q)
    qi, M, cube = qs - 1, m + 2 * b, 2 * b ** 3
    nbytes = 4 * ((2 * n - 1) * b * b + 2 * n * b * m)
    ops = (B * qi * (cube + 6 * b * b * M)  # inverse, panel, back-substitution
           + B * max(qi - 1, 0) * 2 * cube  # L = O G and A - L O^T
           + B * (cube + 6 * b * b * m) + (B - 1) * 2 * cube  # interface
           + B * (6 * cube + 4 * b * b * m)  # the interface terms
           + B * (4 * b * b * m + qi * 4 * b * b * m))  # the interiors
    return nbytes, ops


def tridiag_phase(dev) -> dict:
    """[18] block_tridiag (K6) at the offline cells' banded shape and at
    direct_solve's (K6_SHAPES), float32 SPD systems: against its plain
    version on the card (K6_RTOL of max |x|); timed in turns with the plain
    version and with the op-by-op block_tridiag_solve (the LM's solve
    before K6; no one PyTorch call solves a block-tridiagonal system, so no
    library time); its three kernels' device time from torch.profiler; the
    bound: its bytes over 3.35 TB/s or its float64 operations over 34
    TFLOP/s. Returns the contract row."""
    from lidar_slam_tpu_torch.kernels import tridiag
    from lidar_slam_tpu_torch.models import pose_graph

    row = {"name": "block_tridiag", "route": "cuda",
           "source": "lidar_slam_tpu_torch/csrc/tridiag.cu",
           "replaces": None, "library_ms": None}
    g = torch.Generator(device=dev).manual_seed(18)
    for tag, (n, b, m, q) in K6_SHAPES.items():
        G = torch.randn((n, b, b), generator=g, device=dev)
        A = (torch.eye(b, device=dev) * (4.0 + b) + 0.1 * (G + G.mT))
        O = 0.3 * torch.randn((n - 1, b, b), generator=g, device=dev)
        R = torch.randn((n, b, m), generator=g, device=dev)
        got = tridiag.block_tridiag(A, O, R, q)
        want = tridiag.block_tridiag_solve_plain(A, O, R, q)
        ops_x = pose_graph._block_tridiag_ops(A, O, R, q)
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) / float(want.abs().max())
        ops_err = float((ops_x - want).abs().max()) / float(want.abs().max())
        if not err <= K6_RTOL:
            fail(f"[18] block_tridiag differs from its plain version at "
                 f"{tag} ({n}, {b}, {b}), m = {m}: {err:.3e} of max |x|")
        ms, plain_ms, ops_ms = turns(
            lambda: tridiag.block_tridiag_solve_plain(A, O, R, q),
            lambda: tridiag.block_tridiag(A, O, R, q),
            lambda: pose_graph._block_tridiag_ops(A, O, R, q), 20, 3)
        passes = pass_ms(lambda: tridiag.block_tridiag(A, O, R, q), 20,
                         ("k6_segments", "k6_interface", "k6_interiors"))
        dev_ms = (None if None in passes.values()
                  else sum(passes.values()))
        nbytes, ops = k6_work(n, b, m, q)
        t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / FP64_OPS_S * 1e3
        bnd = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                         "operations")
        print(f"[18] block_tridiag {tag} ({n}, {b}, {b}), m = {m}, q = {q}: "
              f"vs its plain version {err:.3e} of max |x| (op by op in "
              f"float32 {ops_err:.3e}); kernel {ms:.4f} ms, device "
              f"{fmt(dev_ms, 5)} (" + ", ".join(
                  f"{k} {fmt(v, 5)}" for k, v in passes.items())
              + f"); plain {plain_ms:.4f} ms; op by op {ops_ms:.4f} ms; "
              f"bound {bnd[0]:.5f} ms ({bnd[1]}: {nbytes / 1e6:.2f} MB, "
              f"{ops / 1e9:.3f} GFLOP float64)", flush=True)
        sfx = "" if tag == "banded" else f"_{tag}"
        row |= {f"max_abs_err{sfx}": err, f"ms{sfx}": ms,
                f"plain_ms{sfx}": plain_ms, f"op_ms{sfx}": ops_ms,
                f"device_ms{sfx}": dev_ms, f"bound_ms{sfx}": bnd[0],
                f"bound_by{sfx}": bnd[1]}
    return row


def k7_launches() -> dict:
    """The launch counters of K7's three entries."""
    from lidar_slam_tpu_torch.kernels import factors as k7

    return {"lm_linearize": k7.lm_linearize.launches,
            "lm_banded_system": k7.lm_banded_system.launches,
            "lm_cost": k7.lm_cost.launches}


def k7_launches_ok(launches: dict, iterations: int) -> bool:
    """One K7 linearization and one banded assembly an LM iteration, and
    one cost an iteration plus the first."""
    return (launches["lm_linearize"] == launches["lm_banded_system"]
            == iterations >= 1 and launches["lm_cost"] == iterations + 1)


def k7_work(fg, band: int, itemsize: int) -> dict:
    """{entry: (bytes, float64 operations)} of K7's entries on the graph
    fg: each input byte read once and each output byte written once (the
    poses, measurements, gates and index; the blocks, the gradient, A_sup,
    O_sup and R); the operations from K7_FACTOR_OPS and K7_RESIDUAL_OPS a
    factor evaluation (lm_linearize evaluates each factor on both of its
    poses) and 2 x 27 a 3 x 3 block product of the assembly."""
    n, F = fg.n, fg.fi.shape[0]
    n_sup = -(-n // band)
    n_o = max(n_sup - 1, 1)
    index = 4 * (2 * F + (n + 1) + 2 * F)  # fi, fj, start, entries
    graph = itemsize * (9 * F + (F - fg.nb) + 18) + index
    blocks = itemsize * 9 * (1 + 2 * F)
    system = itemsize * ((n_sup + n_o) * 9 * band * band + 3 * band * n_sup)
    return {
        "lm_linearize": (itemsize * 3 * n + graph + blocks + itemsize * 3 * n,
                         2 * F * K7_FACTOR_OPS + 6 * 2 * F),
        "lm_banded_system": (blocks + itemsize * 3 * n + index + system,
                             (4 * F + 1) * 54 + n * 3),
        "lm_cost": (itemsize * 3 * n + graph + itemsize,
                    F * K7_RESIDUAL_OPS + 2 * F),
    }


def factors_phase(dev) -> dict:
    """[19] K7 (kernels/factors.py) on the offline cells' graph shape
    (tests/torch_tridiag_cases.FACTOR_CASES["cells"]): each entry against
    its plain version (K7_RTOL), in float32 and float64; in float32, each
    entry timed in turns with its plain version and with the op-by-op
    function it replaced on the card, its kernel's device time from
    torch.profiler, its bound (bytes over 3.35 TB/s or float64 operations
    over 34 TFLOP/s); the device launches of one banded LM iteration
    (torch.profiler over optimize runs of 2 and 5 iterations, cost_rtol
    0) and its host reads (host.syncs); one float32 optimize at the
    pipeline's LM schedule (SlamConfig().pose_graph, band 10) with K7 and
    again op by op, on the same card. Returns the contract row."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lidar_slam_tpu_torch.config import SlamConfig
    from lidar_slam_tpu_torch.kernels import factors as k7
    from lidar_slam_tpu_torch.models import pose_graph
    from lidar_slam_tpu_torch.utils import tracing

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_tridiag_cases import factor_case, k7_gaps

    row = {"name": "lm_factors", "route": "cuda",
           "source": "lidar_slam_tpu_torch/csrc/factors.cu",
           "replaces": None, "library_ms": None}
    entries = ("lm_linearize", "lm_banded_system", "lm_cost")
    for dtype in (torch.float64, torch.float32):
        x, g, robust, band = factor_case("cells", dtype, dev)
        p = pose_graph._problem(x, g, robust, 1.0)
        fg = pose_graph._on_kernel(p, x.shape[0]).kernel
        lam = torch.tensor(1e-3, dtype=dtype, device=dev)
        J, gr = k7.lm_linearize(fg, x)
        system = k7.lm_banded_system(fg, J, gr, lam, band)
        c = k7.lm_cost(fg, x)
        gaps = k7_gaps((J, gr), system, c, k7.lm_linearize_plain(fg, x),
                       k7.lm_banded_system_plain(fg, J, gr, lam, band),
                       k7.lm_cost_plain(fg, x), band)
        errs = {"lm_linearize": max(gaps["J"], gaps["g"]),
                "lm_banded_system": max(gaps["A"], gaps["O"], gaps["R"]),
                "lm_cost": gaps["cost"]}
        tag = "float64" if dtype is torch.float64 else "float32"
        print(f"[19] K7 {tag} vs its plain versions, {x.shape[0]} poses, "
              f"{len(g.loop_i)} loops ({int(g.loop_mask.sum())} live): "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()),
              flush=True)
        if max(errs.values()) > K7_RTOL[dtype]:
            fail(f"[19] K7 differs from its plain versions in {tag}: {errs}")
        row[f"max_abs_err_{tag}"] = max(errs.values())
    # float32, the cells' dtype: times
    J_op, g_op = pose_graph._linearize(x, p)
    n = x.shape[0]
    calls = {
        "lm_linearize": (lambda: k7.lm_linearize_plain(fg, x),
                         lambda: k7.lm_linearize(fg, x),
                         lambda: pose_graph._linearize(x, p)),
        "lm_banded_system": (
            lambda: k7.lm_banded_system_plain(fg, J, gr, lam, band),
            lambda: k7.lm_banded_system(fg, J, gr, lam, band),
            lambda: pose_graph._banded_system(p, J_op, g_op, lam, n, band)),
        "lm_cost": (lambda: k7.lm_cost_plain(fg, x),
                    lambda: k7.lm_cost(fg, x),
                    lambda: pose_graph._cost(x, p)),
    }
    kernels = {"lm_linearize": "k7_linearize",
               "lm_banded_system": "k7_banded", "lm_cost": "k7_cost"}
    work = k7_work(fg, band, 4)
    totals = dict.fromkeys(("ms", "plain_ms", "op_ms", "device_ms",
                            "bound_ms"), 0.0)
    for name in entries:
        plain, kernel, op = calls[name]
        ms, plain_ms, op_ms = turns(plain, kernel, op, 20, 3)
        dev_ms = device_ms(kernel, 20, kernels[name])
        nbytes, ops = work[name]
        t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / FP64_OPS_S * 1e3
        bnd = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                         "operations")
        print(f"[19] {name} float32: kernel {ms:.4f} ms, device "
              f"{fmt(dev_ms, 5)}; plain {plain_ms:.4f} ms; op by op "
              f"{op_ms:.4f} ms; bound {bnd[0]:.5f} ms ({bnd[1]}: "
              f"{nbytes / 1e6:.3f} MB, {ops / 1e6:.2f} MFLOP float64)",
              flush=True)
        row |= {f"ms_{name}": ms, f"plain_ms_{name}": plain_ms,
                f"op_ms_{name}": op_ms, f"device_ms_{name}": dev_ms,
                f"bound_ms_{name}": bnd[0], f"bound_by_{name}": bnd[1]}
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("op_ms", op_ms),
                       ("device_ms", dev_ms), ("bound_ms", bnd[0])):
            totals[key] = None if v is None or totals[key] is None else (
                totals[key] + v)
    row |= totals
    row["bound_by"] = "bytes"

    def lm_run(iters):
        """(device launches, host reads) of a banded optimize of iters
        LM iterations."""
        tracing.reset()
        tracing.enable()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                res = pose_graph.optimize(x, g, solver="banded", band=band,
                                          max_iters=iters, cost_rtol=0.0)
                torch.cuda.synchronize()
            syncs = tracing.snapshot()["counts"].get("host.syncs", 0)
        finally:
            tracing.disable()
            tracing.reset()
        if res.iterations != iters:
            fail(f"[19] the LM stopped after {res.iterations} of {iters}")
        return (sum(ev.count for ev in prof.key_averages()
                    if ev.device_type == DeviceType.CUDA), syncs)

    lm_run(2)
    (l2, s2), (l5, s5) = lm_run(2), lm_run(5)
    per_it, reads = (l5 - l2) / 3, (s5 - s2) / 3
    print(f"[19] one banded LM iteration (float32, cells' shape): "
          f"{per_it:.2f} device launches, {reads:.2f} host reads "
          f"(bound {K7_MAX_LAUNCHES} launches, 1 read)", flush=True)
    if not (per_it <= K7_MAX_LAUNCHES and reads == 1):
        fail(f"[19] an LM iteration takes {per_it} launches and {reads} "
             "host reads")
    row |= {"launches_lm_iteration": per_it, "host_reads_lm_iteration": reads}

    pg = SlamConfig().pose_graph
    walls = {}
    for tag, on in (("K7", True), ("op by op", False), ("K7 again", True)):
        rule = pose_graph.factor_kernel_path
        if not on:
            pose_graph.factor_kernel_path = lambda *a: False
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = pose_graph.optimize_with_config(x, g, pg)
            torch.cuda.synchronize()
            walls[tag] = (time.perf_counter() - t0, res.iterations,
                          float(res.cost))
        finally:
            pose_graph.factor_kernel_path = rule
    print("[19] optimize_with_config, float32, band 10, cells' shape: "
          + "; ".join(f"{k} {w:.4f} s, {it} LM iterations, cost {c:.9g}"
                      for k, (w, it, c) in walls.items()), flush=True)
    row |= {"optimize_s": walls["K7 again"][0],
            "optimize_op_s": walls["op by op"][0],
            "optimize_iterations": walls["K7 again"][1],
            "optimize_op_iterations": walls["op by op"][1]}
    return row


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
    from lidar_slam_tpu_torch.kernels.icp import icp_sweep_tail
    from lidar_slam_tpu_torch.kernels.nn import nn_argmin
    from lidar_slam_tpu_torch.kernels.raywalk import (OWNER_SIDE, raywalk_bins,
                                                      raywalk_bins_plain,
                                                      raywalk_build,
                                                      raywalk_scan)
    from lidar_slam_tpu_torch.kernels.tridiag import LAUNCHES, block_tridiag
    from lidar_slam_tpu_torch.kernels import factors as k7
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
    k5_64 = k5_check(pts3[1:65], pts3[:64], masks20[1:65], masks20[:64], 50)
    print(f"[3] {k5_line('64 x 1081 x 1081', k5_64)}", flush=True)

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
    nn_argmin.launches = icp_sweep_tail.launches = 0
    raywalk_build.launches = block_tridiag.launches = 0
    k7.lm_linearize.launches = k7.lm_banded_system.launches = 0
    k7.lm_cost.launches = 0
    t0 = time.perf_counter()
    res = slam.run_slam(*args, mode="gtsam", cfg=cfg, device=dev)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {"nn_argmin": nn_argmin.launches,
                "icp_sweep_tail": icp_sweep_tail.launches,
                "raywalk_build": raywalk_build.launches,
                "block_tridiag": block_tridiag.launches,
                **k7_launches()}
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
    if launches["icp_sweep_tail"] != launches["nn_argmin"]:
        fail(f"[5] an ICP sweep missed the fused path: {launches}")
    if launches["block_tridiag"] != LAUNCHES * res.lm_iterations:
        fail(f"[5] an LM solve missed K6: {launches}")
    if not k7_launches_ok(launches, res.lm_iterations):
        fail(f"[5] an LM iteration's factor work missed K7: {launches}")
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
    k5_1 = k5_check(pts3_21[101:102], pts3_21[100:101], masks21[101:102],
                    masks21[100:101], 200)
    print(f"[7] per scan (CUDA events, 100 launches, kernel-plain turns "
          f"{t_plain[0]:.4f}/{t_k[0]:.4f}/{t_k[1]:.4f}/{t_plain[1]:.4f} ms):"
          f" raywalk_scan {scan_ms:.4f} ms, plain scatter + clamp on the GPU"
          f" {scan_plain_ms:.4f} ms; scan_delta (zero grid + unclipped walk)"
          f" {delta_ms:.4f} ms; bound {scan_bound[0]:.5f} ms "
          f"({scan_bound[1]}); nn_argmin B=1 1x1081x1081: {NN_EXACT}; flips "
          f"{flips1:.5f}, gap {gap1:.3e}, kernel {nn1_ms:.4f} ms, plain "
          f"{nn1_plain_ms:.4f} ms, torch.cdist + argmin {nn1_lib_ms:.4f} ms, "
          f"bound {nn1_bound[0]:.5f} ms ({nn1_bound[1]})", flush=True)
    print(f"[7] {k5_line('B=1 1x1081x1081', k5_1)}", flush=True)

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
    icp_sweep_tail.launches = 0
    t0 = time.perf_counter()
    st, step_s, refine_s, refined = stream(n_on)
    wall = time.perf_counter() - t0
    launches_on = {"nn_argmin": nn_argmin.launches,
                   "icp_sweep_tail": icp_sweep_tail.launches,
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
    if launches_on["icp_sweep_tail"] != launches_on["nn_argmin"]:
        fail(f"[8] an ICP sweep missed the fused path: {launches_on}")
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
    dev_k5_1, dev_k5_64 = (device_ms(r[7], n, "icp_sweep_tail_kernel")
                           for r, n in ((k5_1, 200), (k5_64, 50)))
    print(f"[11] icp_sweep_tail under torch.profiler: B=1, 200 launches, "
          f"{fmt(dev_k5_1, 5)} vs CUDA events {k5_1[2]:.4f} ms; 64 pairs, "
          f"50 launches, {fmt(dev_k5_64, 5)} vs {k5_64[2]:.4f} ms",
          flush=True)

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
    # 15. particle filters and relocalization
    launches_pf, nn_pf, k5_pf, dev_k5_pf = pf_reloc_phase(dev, cfg)
    # 16. the 3-D ICP warm-up
    warm = warmup_phase(dev)
    # 17. the multi-rank layer
    launches_sh = sharded_phase(dev, cfg, d20, res, log21, pts21, masks21)
    # 18. the pose graph's block-tridiagonal solve
    k6_row = tridiag_phase(dev)
    k6_row |= {"launches": launches["block_tridiag"],
               "launches_filtered": launches_f["block_tridiag"]}
    # 19. the LM's factor work
    k7_row = factors_phase(dev)
    k7_row |= {"launches": sum(launches[k] for k in k7_launches()),
               "launches_filtered": sum(launches_f[k]
                                        for k in k7_launches())}

    print(card)
    # launches: the main paths' runs, gtsam [5] plus online [8]; the
    # filtered run's [12] apart
    print(json.dumps({"kernels": [
        {"name": "nn_argmin", "route": "cuda",
         "source": "lidar_slam_tpu_torch/csrc/nn.cu",
         "replaces": "lidar_slam_tpu/ops/pallas_nn.py:64",
         "launches": launches["nn_argmin"] + launches_on["nn_argmin"],
         "max_abs_err": max(gap, gap1, nn_pf[1], warm["nn"][1]),
         "ms": nn_ms,
         "plain_ms": nn_plain_ms, "bound_ms": nn_bound[0],
         "bound_by": nn_bound[1], "library_ms": nn_lib_ms,
         "device_ms": dev_nn, "ms_b1": nn1_ms, "plain_ms_b1": nn1_plain_ms,
         "library_ms_b1": nn1_lib_ms, "bound_ms_b1": nn1_bound[0],
         "device_ms_b1": dev_nn1, "host_us_b1": split["nn_argmin_b1"],
         "launches_filtered": launches_f["nn_argmin"],
         "launches_revisit": launches_rv["nn_argmin"],
         "launches_pf_reloc": launches_pf["nn_argmin"],
         "ms_reloc": nn_pf[2], "plain_ms_reloc": nn_pf[3],
         "library_ms_reloc": nn_pf[4], "bound_ms_reloc": nn_pf[5][0],
         "launches_warmup": warm["launches"],
         "max_abs_err_warmup": warm["nn"][1], "ms_warmup": warm["nn"][2],
         "plain_ms_warmup": warm["nn"][3],
         "library_ms_warmup": warm["nn"][4],
         "bound_ms_warmup": warm["nn"][5][0],
         "bound_by_warmup": warm["nn"][5][1],
         "device_ms_warmup": warm["device_ms"],
         "launches_sharded": launches_sh["nn_argmin"]},
        # K5 replaces no Pallas kernel (XLA fuses the JAX loop's tail) and
        # no one PyTorch call computes it; its plain version runs on the
        # card; the warm-up's 3-D sweeps take none ([16] fails otherwise)
        {"name": "icp_sweep_tail", "route": "cuda",
         "source": "lidar_slam_tpu_torch/csrc/icp.cu", "replaces": None,
         "launches": launches["icp_sweep_tail"]
         + launches_on["icp_sweep_tail"],
         "max_abs_err": max(k5_64[0], k5_1[0], k5_pf[0]),
         "max_rad_err": max(k5_64[1], k5_1[1], k5_pf[1]),
         "ms": k5_64[2], "plain_ms": k5_64[3], "bound_ms": k5_64[6][0],
         "bound_by": k5_64[6][1], "library_ms": None,
         "device_ms": dev_k5_64, "sweep_ms": k5_64[4],
         "op_sweep_ms": k5_64[5], "ms_b1": k5_1[2], "plain_ms_b1": k5_1[3],
         "bound_ms_b1": k5_1[6][0], "device_ms_b1": dev_k5_1,
         "sweep_ms_b1": k5_1[4], "op_sweep_ms_b1": k5_1[5],
         "ms_reloc": k5_pf[2], "plain_ms_reloc": k5_pf[3],
         "bound_ms_reloc": k5_pf[6][0], "device_ms_reloc": dev_k5_pf,
         "sweep_ms_reloc": k5_pf[4], "op_sweep_ms_reloc": k5_pf[5],
         "launches_filtered": launches_f["icp_sweep_tail"],
         "launches_revisit": launches_rv["icp_sweep_tail"],
         "launches_pf_reloc": launches_pf["icp_sweep_tail"],
         "launches_sharded": launches_sh["icp_sweep_tail"]},
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
         "launches_revisit": launches_rv["raywalk_build"],
         "launches_pf_reloc": launches_pf["raywalk_build"]},
        {"name": "raywalk_scan", "route": "cuda",
         "source": "lidar_slam_tpu_torch/csrc/raywalk.cu",
         "replaces": "lidar_slam_tpu/ops/raywalk.py:461",
         "launches": launches_on["raywalk_scan"],
         "max_abs_err": max(diff_scan, diff_delta, diff_k1),
         "ms": scan_ms, "plain_ms": scan_plain_ms,
         "bound_ms": scan_bound[0], "bound_by": scan_bound[1],
         "library_ms": None, "device_ms": dev_scan,
         "launches_pf_reloc": launches_pf["raywalk_scan"],
         "launches_sharded": launches_sh["raywalk_scan"]},
        # K6 replaces no Pallas kernel (the JAX solve is lax.scans) and no
        # one PyTorch call computes it; op_ms is the op-by-op solve it
        # replaced on the card
        k6_row,
        # K7 replaces no Pallas kernel (the JAX LM is one jitted program)
        # and no one PyTorch call computes it; op_ms is the op-by-op
        # functions it replaced, on the card
        k7_row,
        *probe_rows,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
