"""Puts the repository root and the benchmark's folder on sys.path for the
benchmark's tests, and builds the small cells they run on the CPU."""

import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402


def tiny_cell(name: str, steps: int = 60, rays: int = 181,
              res: float = 0.2) -> harness.Cell:
    """A cell of BENCHMARK.json cut to a size the CPU runs in seconds: a
    short log of few rays on a 32 m map (coarse by default), small chunks
    and few particles; its limits are the cell's own."""
    cell = harness.load_cell(name)
    c = copy.deepcopy(cell.config)
    c["log"].update(n_steps=steps, n_rays=rays)
    c["map"].update(resolution=res, world_min_x=-16.0, world_max_x=16.0,
                    world_min_y=-16.0, world_max_y=16.0)
    c["chunk_size"] = 16
    c["pf"]["n_particles"] = 32
    c["online"]["n_max"] = 256
    t = dict(cell.traffic)
    for k, v in (("warmup_steps", 5), ("trace_steps", 20),
                 ("judge_steps", 16)):
        if k in t:
            t[k] = v
    return harness.Cell(**{**cell.__dict__, "config": c, "traffic": t})


def cpu_run(cell: harness.Cell, seed: int = 2**31 + 17,
            seconds: float = 0.5, trace: bool = False) -> dict:
    import torch

    torch.set_num_threads(2)
    env = harness.Env(cell=cell, seed=seed, seconds=seconds, trace=trace,
                      device="cpu")
    return harness.run_cell(env, check_device=False)
