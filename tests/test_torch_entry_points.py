"""The port's entry points beside the JAX package's: plot_trajectories and
the examples print what the root scripts print (the same numbers where
the run has no random draws; the particle filters draw from a
torch.Generator, JAX from its own PRNG), and every CLI that computes runs
on the card unless --device says otherwise.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from lidar_slam_tpu_torch import __main__ as gtsam_cli
from lidar_slam_tpu_torch import online_slam, plot_trajectories, warmup_icp
from lidar_slam_tpu_torch.examples import (load_data_demo,
                                           loop_closure_demo,
                                           particle_filter_demo,
                                           pf_slam_demo)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(path, *args, cwd=None) -> str:
    """stdout of one of the JAX package's root scripts, on the CPU."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(ROOT, path), *args],
                         capture_output=True, text=True, env=env,
                         cwd=cwd or ROOT, timeout=600)
    assert out.returncode == 0, out.stderr
    return out.stdout


def _port(main, argv, capsys) -> str:
    assert main(argv) == 0
    return capsys.readouterr().out


def _shape(text: str) -> str:
    """The text with every number replaced by #."""
    return re.sub(r"-?\d+(\.\d+)?", "#", text)


def test_load_data_demo_equals_jax(capsys):
    got = _port(load_data_demo.main, ["--synthetic", "100"], capsys)
    assert got == _jax_script("examples/load_data_demo.py", "--synthetic",
                              "100")
    assert got.count("\n") == 4


def test_loop_closure_demo_equals_jax(capsys):
    """The three gtsam variants on a 120-step revisit log: the same loop
    counts and ATEs to the printed millimetre."""
    args = ["--steps", "120", "--rays", "181"]
    got = _port(loop_closure_demo.main, args + ["--device", "cpu"], capsys)
    want = _jax_script("examples/loop_closure_demo.py", *args)
    assert got == want
    assert [ln[:12] for ln in got.splitlines()] == [
        "[fixed     ]", "[proximity ]", "[descriptor]"]


@pytest.mark.parametrize("demo,path", [
    (particle_filter_demo, "examples/particle_filter_demo.py"),
    (pf_slam_demo, "examples/pf_slam_demo.py")])
def test_particle_filter_demos_print_what_jax_prints(capsys, demo, path):
    """The same lines; the map (known map: the same count) and the dead
    reckoning equal; the filters' errors from their own draws, below dead
    reckoning's mean."""
    args = ["--steps", "60", "--rays", "121", "--particles", "32"]
    got = _port(demo.main, args + ["--device", "cpu"], capsys).splitlines()
    want = _jax_script(path, *args).splitlines()
    assert [_shape(ln) for ln in got] == [_shape(ln) for ln in want]
    assert got[1] == want[1]  # dead reckoning
    if demo is particle_filter_demo:
        assert got[0] == want[0]  # the map from ground truth
    nums = [float(x) for x in re.findall(r"mean (\d+\.\d+)", "".join(got))]
    assert nums[1] < nums[0]


def test_plot_trajectories_cli(tmp_path, capsys):
    for k in range(2):
        np.save(tmp_path / f"p{k}.npy",
                np.cumsum(np.ones((50, 3)) * (k + 1), axis=0))
    out = str(tmp_path / "img" / "t.png")
    got = _port(plot_trajectories.main,
                ["--poses", str(tmp_path / "p0.npy"), str(tmp_path / "p1.npy"),
                 "--labels", "a", "b", "--out", out], capsys)
    assert got == f"saved {out}\n"
    assert open(out, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    want = _jax_script("plot_trajectories.py", "--poses",
                       str(tmp_path / "p0.npy"), "--out",
                       str(tmp_path / "jax.png"), cwd=tmp_path)
    assert want == f"saved {tmp_path / 'jax.png'}\n"


@pytest.mark.parametrize("main,argv", [
    (gtsam_cli.main, ["--mode", "odom", "--synthetic", "5"]),
    (online_slam.main, ["--synthetic", "5", "--res", "0.2", "--width", "8",
                        "--height", "8"]),
    (warmup_icp.main, ["--synthetic", "--num_pc", "1", "--n_seeds", "2"]),
    (loop_closure_demo.main, ["--steps", "20", "--rays", "61"]),
    (particle_filter_demo.main, ["--steps", "5"]),
    (pf_slam_demo.main, ["--steps", "5"])])
def test_entry_points_default_to_the_card(main, argv, tmp_path,
                                          monkeypatch):
    """Without --device every computing entry point asks for CUDA, which
    this host lacks: it raises rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
