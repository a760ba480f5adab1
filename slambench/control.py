"""Readings for the correctness limits of a cell: the numbers its judge
compares, for the program over many seeds (the lower readings) and for
the control over a few (the upper readings).

    python3 slambench/control.py --workload <cell> --seeds 1 2 3 ... \
        --control-seeds 4 5 6 [--steps N] [--out FILE]

The control is the plain reference put in the program's place, run in
float32 with its contractions in TF32 (reference/geometry.tf32: operands
rounded to TF32, products accumulated in float32): the nearest precision
below the float32 with TF32 off that the configurations state. It
produces what the program's timed path produces (scan-matching and loop
transforms, accept flags, optimized poses and the map offline;
each step's pose and the causal map online; each step's estimate with the
particles and weights before and after it for the filter, from the
program's replayed draws), and the cell's judge
compares it like the program's. The program's readings come from the same
path as a run's, on a fixed amount of work: one log offline, N steps
(default the traffic's trace_steps x 5) streaming. The benchmark's runs do
not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                os.path.dirname(os.path.abspath(__file__))]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import harness  # noqa: E402
from reference import geometry as geo  # noqa: E402
from reference import mapping as rmap  # noqa: E402
from reference import pf as rpf  # noqa: E402


def setup(cell: harness.Cell, seed: int, device: str):
    """The runner and its set-up for one seed, with one log and no warm-up
    (readings need no timing)."""
    tr = dict(cell.traffic, logs=1)
    for k in ("warmup_logs", "warmup_steps"):
        if k in tr:
            tr[k] = 0
    cell = harness.Cell(**{**cell.__dict__, "traffic": tr})
    env = harness.Env(cell=cell, seed=seed, seconds=0.0, trace=False,
                      device=device)
    runner = harness.load_module("runners", tr["runner"])
    return runner, runner.setup(env)


def program_outputs(runner, st, steps: int):
    kind = st.tr["runner"]
    if kind == "offline":
        res = runner.one(st, 0)
        return runner.outputs(st, 0, res, st.loops[-1])
    if kind == "stream_slam":
        _, _, state, i = runner.stream(st, None, steps)
        return runner.outputs(state, i)
    _, _, rec = runner.stream(st, None, steps)
    return runner.outputs(st, rec)


def control_outputs(runner, st, steps: int):
    """The reference in float32 with TF32 matmuls, in the program's place,
    on the same work as program_outputs."""
    f32, dev, kind = torch.float32, st.dev, st.tr["runner"]
    with geo.tf32():
        if kind == "offline":
            ref = runner.pipeline(st, 0, f32)
            return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                        else v) for k, v in ref.items()
                    if k in ("log", "sm_rel", "loop_T", "accept",
                             "poses_opt", "logodds", "sm_iters")}
        if kind == "stream_slam":
            rel = runner.step_transforms(st, 0, list(range(1, steps + 1)),
                                         f32)
            T = torch.eye(3, dtype=f32, device=dev)
            poses = [geo.pose_of(T)]
            for k in range(steps):
                T = geo.mm(T, rel[k])
                poses.append(geo.pose_of(T))
            poses = torch.stack(poses)
            pts, msk = runner.common.points(st, 0, f32)
            grid = rmap.build(poses, pts[:steps + 1], msk[:steps + 1],
                              runner.common.map_geometry(st.cfg),
                              runner.common.lidar_geometry(st.cfg)["p_rl"])
            return {"log": 0, "poses": poses.cpu().numpy(),
                    "logodds": grid.cpu().numpy()}
        occ, pts, msk = runner.reference_map(st, 0, f32)
        m = runner.common.map_geometry(st.cfg)
        rob, pf = st.cfg["robot"], st.cfg["pf"]
        log = st.logs[0]
        P = st.pcfg.n_particles
        noise = runner.draws(st, [(0, t) for t in range(1, steps + 1)])
        particles = torch.zeros(P, 3, dtype=f32, device=dev)
        logw = torch.full((P,), -np.log(P), dtype=f32, device=dev)
        rec = []
        for t in range(1, steps + 1):
            counts = torch.as_tensor(log["counts"][t], device=dev)
            v = geo.encoder_speed(counts, rob["dist_per_tick"],
                                  rob["encoder_freq"])
            eps_v, eps_w, u = noise[0, t]
            new_p, new_w, est = rpf.step(particles, logw, v,
                                         float(log["gyro"][t, 2]), eps_v,
                                         eps_w, u, pts[t], msk[t], occ, m, pf)
            rec.append((0, t, 0, particles, logw, new_p, new_w,
                        est.cpu().numpy()))
            particles, logw = new_p, new_w
        return runner.outputs(st, rec)


def readings(cell, seeds, make, steps, device):
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        runner, st = setup(cell, seed, device)
        out = make(runner, st, steps)
        vals = runner.judge(st, out)
        rows.append({"seed": seed, **vals,
                     "seconds": time.perf_counter() - t0})
        print(json.dumps(rows[-1]), flush=True)
        del st, out
        if device == "cuda":
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    steps = args.steps or 5 * cell.traffic.get("trace_steps", 1)
    res = {"workload": args.workload, "steps": steps,
           "program": readings(cell, args.seeds, program_outputs, steps,
                               args.device),
           "control": readings(cell, args.control_seeds, control_outputs,
                               steps, args.device)}
    for side in ("program", "control"):
        rows = res[side]
        if rows:
            keys = [k for k in rows[0] if k not in ("seed", "seconds")
                    and isinstance(rows[0][k], (int, float))]
            print(side, {k: (min(r[k] for r in rows), max(r[k] for r in rows))
                         for k in keys}, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
