"""The per-visit and per-ray cost of a tile-RMW walk on the card (P9).

Replaces tools/vpu_probe.py (make_kernel :76 via build_call :207), which
timed stripped Pallas loops replicating the v8 walk kernel's per-visit
work (ops/raywalk.py _make_kernel_v8 emit()) to decompose its cost:

  rmw     two alternating (64, 128) tile RMWs per iteration, no mask
  vec     the emit() mask chain + tile RMW, words from the loop index
  full    vec with the words read from a table in device memory
  fullv   full with the table staged through shared memory (the
          counterpart of SMEM scalar prefetch against a VMEM block)
  ray1    v8's per-ray prologue (six aux words, DR and V0) + one visit
  ray2    the same prologue + two visits

The TPU tool's grid=(1,) kernel was the whole v5e chip; on the card the
kernel spreads the grid's cells over all of it, a block for each 8 x 128
owner of a (64, 128) tile position, each cell in a register of its
thread, each block walking the visits of its tile in order
(csrc/probes.cu "P9"). So the slopes below are the whole card's: what a
visit costs when every tile's visits run at once, not the serial cost on
one multiprocessor that the K2 map kernel's one warp pays (the earlier
one-block kernel measured 545.0 ns a visit on one SM; PERF.md). Each
mode is timed at 8 and 40 repetitions of m1 pairs; the slope between
them is the marginal cost (launch overhead and the one-time filter of
the visits cancel): ns per visit for the pair modes, ns per ray for the
ray modes. per-ray setup = 2 slope(ray1) - slope(ray2). A block tests
every cell of its part of a visit's tile, after skipping the visits
whose mask band misses its rows, so a visit's cost depends on the cells
and rows it writes, which differ between the modes (printed as
cells/visit): the slopes of two modes are not a decomposition of one
another. The grid (512 x 512, 1 MB) is read and written once a call.

    python -m lidar_slam_tpu_torch.tools.vpu_probe [--m1 16384] [--reps 5]
        [--modes rmw,vec,full,fullv,ray1,ray2]

Times are the best of `--reps` calls, each on new words and a new grid
(CUDA events).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..kernels import probes
from . import card, events_ms, require_cuda

TS = probes.VPU_TS
LANES = probes.LANES
GRID = 512  # (512, 512) float32 probe grid = 1 MB
R1, R2 = 8, 40  # the two repetition counts of the slope
M1 = 16384  # pairs a repetition (the JAX tool's default)
N_RAYS_DS = 4956 * 1081  # dataset-20 scans x rays
CELLS_PAIRS = 2048  # pairs whose visits' cells are counted


def words_for(n_pairs: int, seed: int, rays: bool = False) -> np.ndarray:
    """The JAX tool's word table: (4, n_pairs) int32 of two (C, w2) visits
    per pair, or (10, min(n_pairs, 4096)) with six per-ray aux words."""
    n_row_t, n_lane_t = GRID // TS, GRID // LANES
    r = np.random.default_rng(seed)
    if rays:
        n_pairs = min(n_pairs, probes.RAY_W_MAX)
    w = np.empty((10 if rays else 4, n_pairs), np.int32)
    w[0] = r.integers(0, 1024, n_pairs)
    w[2] = r.integers(0, 1024, n_pairs)
    for row in (1, 3):
        tile = (r.integers(0, n_lane_t, n_pairs)
                | (r.integers(0, n_row_t, n_pairs) << 4))
        w[row] = (r.integers(0, 64, n_pairs)
                  | (r.integers(0, 64, n_pairs) << 7) | (tile << 15))
    if rays:
        # per-ray aux fields with dataset-realistic distributions
        w[4] = r.integers(0, 2, n_pairs)            # steep
        w[5] = r.integers(0, 2, n_pairs) * 2 - 1    # sgM
        w[6] = r.integers(0, 2, n_pairs) * 2 - 1    # sgm
        w[7] = r.integers(1, 608, n_pairs)          # dM
        w[8] = r.integers(0, 64, n_pairs)           # dm
        w[9] = r.integers(0, 128, n_pairs)          # deg (d_end_g)
    return w


def cells_per_visit(words: torch.Tensor, n_pairs: int, mode: str) -> float:
    """Mean cells a visit writes (its mask's cells inside the grid) over the
    first CELLS_PAIRS pairs of a repetition (a visit's cost on the card
    depends on it: the kernel skips the cells outside the mask)."""
    n = []
    for rt, lt, delta in probes.vpu_visits(words, min(n_pairs, CELLS_PAIRS),
                                           mode):
        r0, c0 = max(rt, 0), max(lt, 0)
        n.append(int(torch.count_nonzero(
            delta[r0 - rt:GRID - rt, c0 - lt:GRID - lt])))
    return sum(n) / len(n)


def run(m1: int = M1, reps: int = 5, modes=probes.VPU_MODES,
        log=print) -> dict:
    """Returns {"times": {mode: (s at R1, s at R2)}, "slopes": {mode: ns
    per unit}, "cells": {mode: cells a visit}} plus, when the modes are
    there, the derived floors."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def timed(mode, n_pairs, reps_k):
        rays = mode in ("ray1", "ray2")
        best = np.inf
        for rep in range(reps):
            w = torch.as_tensor(words_for(n_pairs, 10 + rep, rays=rays),
                                device=dev)
            g = torch.as_tensor(rng.normal(0, 1, (GRID, GRID)),
                                dtype=torch.float32, device=dev)
            torch.cuda.synchronize()
            best = min(best, events_ms(lambda: probes.vpu_loop(
                w, g, n_pairs, mode, reps_k)) / 1e3)
        return best

    log(f"mode     t({R1}x{m1})   t({R2}x{m1})   ns/unit (slope)   "
        f"cells/visit (first {min(m1, CELLS_PAIRS)} pairs)")
    times, slopes, cells = {}, {}, {}
    for mode in modes:
        timed(mode, m1, R1)  # warm-up (the first call builds the kernels)
        t1 = timed(mode, m1, R1)
        t2 = timed(mode, m1, R2)
        # pair modes do 2 visits/iteration (unit = visit); ray modes are
        # per-RAY slopes (unit = ray-iteration)
        denom = m1 * (R2 - R1) * (1 if mode in ("ray1", "ray2") else 2)
        slopes[mode] = (t2 - t1) / denom * 1e9
        times[mode] = (t1, t2)
        cells[mode] = cells_per_visit(torch.as_tensor(words_for(
            m1, 10, rays=mode in ("ray1", "ray2"))), m1, mode)
        log(f"{mode:7s}  {t1 * 1e3:8.2f}ms  {t2 * 1e3:8.2f}ms  "
            f"{slopes[mode]:6.2f}  {cells[mode]:8.1f}")
    res = {"times": times, "slopes": slopes, "cells": cells}
    # A visit's cost depends on the cells it writes, which differ between
    # the modes: the TPU tool's differences of modes (vec - rmw, full -
    # vec) are not a decomposition here and are not printed.
    if "full" in slopes:
        log(f"tile-RMW visit (full): {slopes['full']:.2f} ns/visit on the "
            f"whole card at {cells['full']:.1f} cells/visit")
    if {"ray1", "ray2"} <= slopes.keys():
        res["setup_ns"] = 2 * slopes["ray1"] - slopes["ray2"]
        res["visit_in_situ_ns"] = slopes["ray2"] - slopes["ray1"]
        log(f"per-ray setup (2*ray1 - ray2): {res['setup_ns']:.2f} ns/ray")
        log(f"in-situ visit cost (ray2 - ray1): "
            f"{res['visit_in_situ_ns']:.2f} ns/visit")
        log(f"dataset-20 per-ray setup total ({N_RAYS_DS / 1e6:.2f}M rays): "
            f"{res['setup_ns'] * N_RAYS_DS / 1e9:.3f} s")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m1", type=int, default=M1)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--modes", type=str, default=",".join(probes.VPU_MODES),
                    help="comma-separated subset of "
                         + ",".join(probes.VPU_MODES))
    args = ap.parse_args(argv)
    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    if not set(modes) <= set(probes.VPU_MODES):
        ap.error(f"unknown mode in {args.modes!r}")
    require_cuda("vpu_probe")
    print(card(), flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    run(args.m1, args.reps, modes)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
