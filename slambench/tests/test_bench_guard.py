"""No run loads JAX or the JAX package (top-level names compared whole),
the reference imports nothing of the program, nothing reads the old TPU
bench files, and a run refuses to measure without a card."""

import ast
import json
import os
import shutil
import subprocess
import sys

from bench_paths import BENCH, ROOT, harness


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_forbidden_modules_compares_whole_top_level_names():
    mods = ["lidar_slam_tpu_torch", "lidar_slam_tpu_torch.models.slam",
            "jaxtyping", "flaxen", "numpy", "lidar_slam_tpu.models",
            "jax.numpy", "jaxlib", "flax"]
    assert harness.forbidden_modules(mods) == [
        "flax", "jax.numpy", "jaxlib", "lidar_slam_tpu.models"]


def test_reference_imports_nothing_of_the_program_or_jax(tmp_path):
    assert harness.reference_imports() == []
    (tmp_path / "reference").mkdir()
    (tmp_path / "reference" / "bad.py").write_text(
        "import numpy\nfrom lidar_slam_tpu_torch.ops import icp\n"
        "from . import geometry\nimport jax.numpy as jnp\n")
    assert harness.reference_imports(tmp_path) == [
        "bad.py: lidar_slam_tpu_torch.ops", "bad.py: jax.numpy"]


def test_no_source_imports_jax_or_reads_the_old_bench():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".", 1)[0] not in harness.FORBIDDEN, (path,
                                                                    name)
        if path.parent.name != "tests":
            text = path.read_text()
            for old in ("bench.py", "BENCH_r", "BASELINE", "MULTICHIP_r"):
                assert old not in text, (path, old)


def _run(cwd, extra_env=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(extra_env or {}))
    return subprocess.run(
        [sys.executable, "slambench/run.py", "--workload",
         "ds20.offline_gtsam", "--seed", "3", "--seconds", "1", "--trace",
         "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_run_refuses_without_a_card():
    p = _run(ROOT)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "CUDA" in p.stderr


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert "{" not in p.stdout


def test_run_refuses_when_jax_is_loaded(tmp_path):
    # a sitecustomize that loads a module named jax before the harness
    (tmp_path / "jax.py").write_text("")
    (tmp_path / "sitecustomize.py").write_text("import jax\n")
    p = _run(ROOT, {"PYTHONPATH": str(tmp_path)})
    assert p.returncode != 0
    assert "{" not in p.stdout and "jax" in p.stderr


def test_manifest_names_no_file_outside_paths():
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    for word in man["command"][1:]:
        assert word.startswith("slambench/") and ".." not in word
