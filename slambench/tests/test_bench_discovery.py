"""Adding a configuration, a traffic mix, a cell or a metric is adding
files and manifest entries: the harness finds each by its name, and no
file it had changes."""

import json
import shutil

from bench_paths import BENCH, ROOT, harness


def test_extra_cell_config_traffic_and_metric(tmp_path):
    bench = tmp_path / "slambench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    man = json.loads((ROOT / "BENCHMARK.json").read_text())

    cfg = json.loads((bench / "configs" / "ece276a_ds20.json").read_text())
    cfg["name"] = "extra_deploy"
    cfg["log"]["n_steps"] = 1000
    (bench / "configs" / "extra_deploy.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "extra_mix.json").write_text(json.dumps(
        {"runner": "stream_slam", "logs": 3, "warmup_steps": 10,
         "trace_steps": 50, "judge_steps": 64}))
    (bench / "workloads" / "extra.cell.json").write_text(json.dumps(
        {"limits": {"step_gap": 1.0, "map_cells": 1.0}}))
    (bench / "metrics" / "extra.steps.py").write_text(
        "def read(run):\n    return run.work.get('steps')\n")
    man["configs"].append({"name": "extra_deploy", "source": "x",
                           "file": "slambench/configs/extra_deploy.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "extra.cell", "config": "extra_deploy",
                             "traffic": "extra_mix", "chips": 1, "why": "x"})
    man["per_layer"].append({"name": "extra.steps", "unit": "steps",
                             "better": "higher", "source": "host_clock",
                             "layer": "x", "moves": "online_steps_per_s",
                             "workloads": ["extra.cell"]})

    cell = harness.load_cell("extra.cell", man, bench)
    assert cell.config["log"]["n_steps"] == 1000
    assert cell.traffic["logs"] == 3
    assert cell.spec["limits"]["map_cells"] == 1.0
    assert [m["name"] for m in cell.per_layer] == ["extra.steps"]
    run = harness.Run(work={"steps": 7})
    got = harness.read_metrics(run, cell.per_layer, bench)
    assert got == {"extra.steps": {"value": 7.0, "unit": "steps"}}
    # the cells that were there still resolve, and no old file changed
    for w in man["workloads"][:-1]:
        harness.load_cell(w["name"], man, bench)
    assert all(p.read_bytes() == b for p, b in before.items())


def test_metric_that_finds_nothing_is_left_out(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "none.py").write_text(
        "def read(run):\n    return None\n")
    got = harness.read_metrics(harness.Run(),
                               [{"name": "none", "unit": "%"}], tmp_path)
    assert got == {}
