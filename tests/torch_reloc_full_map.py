"""Global relocalization on the seed-21 log's ground-truth maps, in the JAX
package and in the port, both on the CPU: the record behind chip_smoke.py
[15] (c)'s RELOC_ALGORITHM_MISSES.

    python tests/torch_reloc_full_map.py [--threads 8]

Both packages run relocalize_refined at the online CLI's budget (centred,
radius half the map's diagonal, 360 angles, beam 4,096, 256 rays, 8
candidates) on one float32 map and one set of float32 points:

- scans 600, 1,800, 3,000 and 4,200 on the whole log's map (4,956 scans x
  1,081 rays at 0.05 m on 1201 x 1201 cells; its later passes' free-space
  rays carve the walls down to a few thousand occupied cells). Both
  packages miss each of them by more than 5 cm or 0.03 rad;
- scan 600 of the generator's 1,200-step log (`synthetic_dataset(1200,
  1081, seed=21)`: a smaller room, so shorter rays) on that log's map.
  Both packages find it, certified, and refine it within 5 cm and 0.03
  rad; on the long log's map, scan 600 of the long log's first 1,200
  steps is missed, as on the whole log's.

It prints one line a case and package, and exits 1 if a package misses a
pose the other finds, or if either result is not the one stated above.
For each case it also runs the port's polish with the nearest-neighbour
kernel's own rounding (kernels/nn.nn_argmin_rounded, what the card
computes) in place of the plain search and prints how far the refined
pose moves: the share of chip_smoke.py's card-against-CPU refined-pose
gap that near-tie flips alone explain.
The maps come from the port's plain map build (the scatter path, which
chip_smoke.py holds bit-exact to the ray-walk kernel). It takes a few
minutes, most of it the long log's maps: too long for the test suite.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import lidar_slam_tpu.config as jc  # noqa: E402
from lidar_slam_tpu.models import relocalization as jrl  # noqa: E402

import lidar_slam_tpu_torch.config as tc  # noqa: E402
from lidar_slam_tpu_torch.kernels import nn as knn  # noqa: E402
from lidar_slam_tpu_torch.models import occupancy  # noqa: E402
from lidar_slam_tpu_torch.models import relocalization as trl  # noqa: E402
from lidar_slam_tpu_torch.ops import icp as icp_ops  # noqa: E402
from lidar_slam_tpu_torch.ops import scan as scan_ops  # noqa: E402
from lidar_slam_tpu_torch.utils import io  # noqa: E402

SCANS = (600, 1800, 3000, 4200)
FOUND_SCAN, FOUND_STEPS = 600, 1200  # chip_smoke.py's RELOC_GATED_*
POS_TOL, YAW_TOL = 0.05, 0.03  # m, rad: chip_smoke.py's RELOC_*_TOL


def yaw_err(a: float, b: float) -> float:
    return abs((a - b + np.pi) % (2 * np.pi) - np.pi)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=8,
                    help="torch CPU threads for the map builds")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    m = tc.MapConfig.from_cli(0.05, 60, 60)
    jm = jc.MapConfig.from_cli(0.05, 60, 60)
    K = occupancy.max_ray_cells(m, 30.0)
    kw = dict(search_radius=0.5 * math.hypot(60.0, 60.0), beam=4096,
              n_angles=360, max_rays=256)
    logs = {}
    # (log, the first `steps` of it mapped)
    for n, steps in ((4956, 4956), (4956, FOUND_STEPS),
                     (FOUND_STEPS, FOUND_STEPS)):
        if n not in logs:
            d = io.synthetic_dataset(n_steps=n, n_rays=1081, seed=21)
            pts, masks = scan_ops.scans_to_points(
                torch.as_tensor(d["lidar"]["ranges"], dtype=torch.float32),
                0.1, 30.0, tc.SlamConfig().lidar)
            logs[n] = (np.asarray(d["ground_truth"], np.float32), pts, masks,
                       {})
        gt, pts, masks, maps = logs[n]
        t0 = time.perf_counter()
        maps[steps] = occupancy.build_logodds(
            torch.as_tensor(gt[:steps]), pts[:steps], masks[:steps], m, K)
        print(f"{n}-step log, map of its first {steps} steps: "
              f"{time.perf_counter() - t0:.1f} s, "
              f"{int((maps[steps] > 0).sum())} occupied cells", flush=True)
    cases = [(4956, 4956, k, False) for k in SCANS]
    cases += [(4956, FOUND_STEPS, FOUND_SCAN, False),
              (FOUND_STEPS, FOUND_STEPS, FOUND_SCAN, True)]
    wrong = []
    for n, steps, k, expect_found in cases:
        gt, pts, masks, maps = logs[n]
        lo = maps[steps]
        found, certified = {}, {}
        for pkg in ("jax", "port"):
            t0 = time.perf_counter()
            if pkg == "jax":
                g, r, e = jrl.relocalize_refined(
                    jnp.asarray(lo.numpy()), jm, jnp.asarray(pts[k].numpy()),
                    jnp.asarray(masks[k].numpy()), jrl.RelocConfig(**kw),
                    center=(0.0, 0.0), n_candidates=8)
            else:
                g, r, e = trl.relocalize_refined(
                    lo, m, pts[k], masks[k], trl.RelocConfig(**kw),
                    center=(0.0, 0.0), n_candidates=8)
            gp, r = np.asarray(g.pose), np.asarray(r)
            pe = float(np.hypot(*(r[:2] - gt[k, :2])))
            ye = yaw_err(float(r[2]), float(gt[k, 2]))
            found[pkg] = pe <= POS_TOL and ye <= YAW_TOL
            certified[pkg] = bool(g.certified)
            print(f"{pkg} scan {k} of the {n}-step log on its first "
                  f"{steps} steps' map: "
                  f"{time.perf_counter() - t0:.1f} s; grid score "
                  f"{float(g.score):.0f}, certified {bool(g.certified)}, "
                  f"margin {float(g.pruned_margin):.0f}; grid pose error "
                  f"{float(np.hypot(*(gp[:2] - gt[k, :2]))):.4f} m, "
                  f"{yaw_err(float(gp[2]), float(gt[k, 2])):.4f} rad; "
                  f"refined {pe:.4f} m, {ye:.4f} rad (ICP error "
                  f"{float(e):.3e}); found {found[pkg]}", flush=True)
        r_plain = r
        icp_ops.nn_argmin = knn.nn_argmin_rounded
        _, r_rounded, _ = trl.relocalize_refined(
            lo, m, pts[k], masks[k], trl.RelocConfig(**kw),
            center=(0.0, 0.0), n_candidates=8)
        icp_ops.nn_argmin = knn.nn_argmin
        gap = float(np.abs(r_rounded.numpy() - r_plain).max())
        print(f"port scan {k}, the polish on the kernel's rounding: refined "
              f"pose max diff {gap:.3e}", flush=True)
        if (found["jax"] != expect_found or found["port"] != expect_found
                or expect_found and not all(certified.values())):
            wrong.append((n, steps, k))
    print(f"cases whose result is not the stated one: {wrong}")
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
