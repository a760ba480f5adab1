"""BENCHMARK.json loads and keeps to the benchmark's contract: names,
units and lengths, the keys of each entry, and a file for every
configuration, traffic mix, cell and metric."""

import json
import re

import pytest

from bench_paths import BENCH, ROOT, harness

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "slambench/run.py"]
    assert MAN["paths"] == ["slambench"]
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= MAN["run_seconds"] <= 51
    assert all(one_line(w) for w in MAN["command"])
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_names_units_and_lengths():
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[key]:
            assert NAME.fullmatch(e["name"]), e["name"]
            names.append((key, e["name"]))
    for key in ("configs", "workloads"):
        got = [e["name"] for e in MAN[key]]
        assert len(got) == len(set(got))
    metrics = [e["name"] for k in ("end_to_end", "per_layer")
               for e in MAN[k]]
    assert len(metrics) == len(set(metrics))
    for e in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.fullmatch(e["unit"]), e["unit"]
        assert e["better"] in ("lower", "higher")
    for c in MAN["configs"]:
        assert one_line(c["source"]) and one_line(c["why"])
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in MAN["workloads"]:
        assert one_line(w["why"])
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4)
    for m in MAN["per_layer"]:
        assert one_line(m["layer"])


def test_entry_keys():
    assert all(set(c) == {"name", "source", "file", "reduced", "why"}
               for c in MAN["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"}
               for w in MAN["workloads"])
    e2e = {"name", "unit", "better", "bound", "source"}
    assert all(set(m) - {"workloads"} == e2e for m in MAN["end_to_end"])
    pl = {"name", "unit", "better", "source", "layer", "moves"}
    assert all(set(m) - {"workloads"} == pl for m in MAN["per_layer"])


def test_bounds_and_sources():
    names = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in names
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in names


def test_every_cell_reports_what_it_must():
    cells = {w["name"] for w in MAN["workloads"]}
    for cell in cells:
        e2e = [m["name"] for m in MAN["end_to_end"]
               if harness.applies(m, cell)]
        pl = [m for m in MAN["per_layer"] if harness.applies(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert pl and all(m["moves"] in e2e for m in pl)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    cell = harness.load_cell(w["name"], MAN)
    assert cell.config["name"] == w["config"]
    assert harness.find("runners", cell.traffic["runner"]).is_file()
    assert set(cell.spec["limits"])
    for m in cell.end_to_end + cell.per_layer:
        assert hasattr(harness.load_module("metrics", m["name"]), "read")


def test_config_files_lie_under_paths():
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and BENCH in path.resolve().parents
        assert json.loads(path.read_text())["source"] == c["source"]
