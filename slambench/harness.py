"""The benchmark's core: it finds a cell's files by the names in
BENCHMARK.json, runs the cell's runner, judges its outputs against the
plain reference, reads the cell's metrics and prints one result line.

Everything that belongs to one configuration, traffic mix, cell or metric
lives in a file of its own under this folder, found by name:

    configs/<config>.json     the deployment: sizes, settings, source
    traffic/<traffic>.json    the mix: which runner runs it, logs, warm-up,
                              traced work and the judge's sample
    workloads/<cell>.json     the cell's limits on the numbers compared
    runners/<runner>.py       a runner kind (set-up, window, traced run,
                              outputs for the judge, the judge itself)
    metrics/<metric>.py       read(run) -> value or None, one a metric

so a new configuration, mix, cell or metric is new files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Any

import common

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lidar_slam_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: lidar_slam_tpu_torch is not lidar_slam_tpu."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def reference_imports(bench_dir: Path = BENCH_DIR) -> list[str]:
    """Modules of the program (lidar_slam_tpu_torch) or of FORBIDDEN that
    a file of reference/ imports, as "file: module"; the reference must
    import none."""
    import ast

    bad = FORBIDDEN + ("lidar_slam_tpu_torch",)
    out = []
    for path in sorted((bench_dir / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.module and not node.level else [])
            out += [f"{path.name}: {n}" for n in names
                    if n.split(".", 1)[0] in bad]
    return out


def process_seconds() -> float:
    """Seconds since this process started, from the kernel's record of its
    start (Linux); since this module's import where there is none."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find(kind: str, name: str, bench_dir: Path = BENCH_DIR) -> Path:
    """The file of `name` under kind/ (configs, traffic, workloads: .json;
    runners, metrics: .py)."""
    ext = ".py" if kind in ("runners", "metrics") else ".json"
    path = bench_dir / kind / f"{name}{ext}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return path


def load_module(kind: str, name: str, bench_dir: Path = BENCH_DIR):
    """Import runners/<name>.py or metrics/<name>.py (names may hold
    dots, so by path)."""
    path = find(kind, name, bench_dir)
    spec = importlib.util.spec_from_file_location(
        f"slambench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One cell with its files loaded."""

    name: str
    entry: dict       # the workloads entry of BENCHMARK.json
    config: dict      # configs/<config>.json
    traffic: dict     # traffic/<traffic>.json
    spec: dict        # workloads/<cell>.json
    end_to_end: list  # the manifest's end_to_end entries this cell reports
    per_layer: list   # the manifest's per_layer entries this cell reports


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, man: dict | None = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    man = manifest() if man is None else man
    entries = [w for w in man["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       + ", ".join(w["name"] for w in man["workloads"]))
    entry = entries[0]
    return Cell(
        name=name, entry=entry,
        config=load_json(find("configs", entry["config"], bench_dir)),
        traffic=load_json(find("traffic", entry["traffic"], bench_dir)),
        spec=load_json(find("workloads", name, bench_dir)),
        end_to_end=[m for m in man["end_to_end"] if applies(m, name)],
        per_layer=[m for m in man["per_layer"] if applies(m, name)])


@dataclasses.dataclass
class Env:
    """What a runner is given: the cell, the run's arguments, the device,
    and the process's start for set-up time."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    bench_dir: Path = BENCH_DIR


@dataclasses.dataclass
class Run:
    """What a runner hands back: the measurements the metric readers read
    and the outputs the judge compares."""

    setup_s: float = 0.0
    attempted: int = 0           # logs (offline) or steps (streams) run
    window_s: float = 0.0        # host seconds of the measured window
    work: dict = dataclasses.field(default_factory=dict)
    trace: dict | None = None    # trace.reduce()'s result in traced runs
    outputs: Any = None          # for the judge
    state: Any = None            # the runner's set-up, for the judge
    device: dict = dataclasses.field(default_factory=dict)  # by run_cell


def read_metrics(run: Run, metrics: list, bench_dir: Path = BENCH_DIR):
    """{name: {"value", "unit"}} of the metrics whose reader finds
    something to read."""
    out = {}
    for m in metrics:
        value = load_module("metrics", m["name"], bench_dir).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(runner, run: Run, cell: Cell) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): every number compared must
    be finite and at most its limit in workloads/<cell>.json."""
    values = runner.judge(run.state, run.outputs)
    limits = cell.spec["limits"]
    checks = {k: {"value": float(values[k]), "limit": float(limits[k])}
              for k in limits if k in values}
    missing = sorted(set(limits) - set(values))
    ok = not missing and all(
        c["value"] == c["value"] and c["value"] <= c["limit"]
        for c in checks.values())
    return ok, checks


def run_cell(env: Env, check_device: bool = True) -> dict:
    """One run of a cell: set-up, the window or the traced run, the judge
    and the metrics. Returns the result line's object; raises SystemExit
    without a result when the cell's devices are missing or a module of
    JAX or of the JAX package was loaded by the time the window closed."""
    import torch

    cell = env.cell
    runner = load_module("runners", cell.traffic["runner"], env.bench_dir)
    need = int(cell.entry["chips"])
    if check_device and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < need):
        raise SystemExit(
            f"no result: {cell.name} needs {need} CUDA device(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count()}")
    torch.set_num_threads(1)  # one host thread: steadier timing
    run = runner.run(env)
    run.device = common.device_record(torch.device(env.device))
    if run.trace is not None:
        run.device["busy_s"] = run.trace["busy_s"]
        run.device["window_s"] = run.trace["window_s"]
    correct, checks = judge(runner, run, cell)
    metrics = read_metrics(run, cell.per_layer if env.trace
                           else cell.end_to_end, env.bench_dir)
    found = forbidden_modules()
    if found:
        raise SystemExit("no result: modules of JAX or of the JAX package "
                         "were loaded: " + ", ".join(found))
    result = {"correct": bool(correct), "attempted": int(run.attempted),
              "failed": 0, "metrics": metrics, "device": run.device}
    if env.trace and run.trace is not None:
        result["breakdown"] = run.trace["breakdown"]
    result["_phases"] = run.work.get("setup_phases", {})
    result["_window"] = {"attempted": run.attempted,
                         "window_s": run.window_s}
    result["compared"] = checks
    return result


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    found = forbidden_modules()
    if found:
        print("no result: modules of JAX or of the JAX package are loaded "
              "at start-up: " + ", ".join(found), file=sys.stderr)
        return 2
    found = reference_imports()
    if found:
        print("no result: the reference imports the program or JAX: "
              + ", ".join(found), file=sys.stderr)
        return 2
    env = Env(cell=load_cell(args.workload), seed=args.seed,
              seconds=args.seconds, trace=bool(args.trace), device="cuda")
    result = run_cell(env)
    print("setup phases (s): " + json.dumps(result.pop("_phases", {})),
          file=sys.stderr)
    print("window: " + json.dumps(result.pop("_window", {})),
          file=sys.stderr)
    for k, c in result["compared"].items():
        print(f"compared {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
