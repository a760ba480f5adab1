"""The control comes out not correct: the plain reference in the program's
place, in float32 with TF32 matmuls (control.py), fails at least one of
its cell's limits on each of three seeds, while the program passes them,
on short logs on the card. Run on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda slambench/tests
"""

import copy

import pytest

from bench_paths import harness, tiny_cell
import control  # noqa: E402

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the program's kernels and TF32)")
    return "cuda"


def _fails(cell, row) -> bool:
    lim = cell.spec["limits"]
    return any(not row[k] <= lim[k] for k in lim)


def _cell(name):
    """(cell, steps read): the filter at its deployment's particles, rays
    and cells on a log of 1,200 steps, 1,000 read (its limits are set
    for the deployment: 150 steps of 32 particles on a coarse map read
    over them on sound runs); the others on 200-step logs of 1,081 rays,
    150 read."""
    if "localize" not in name:
        return tiny_cell(name, steps=200, rays=1081), 150
    cell = harness.load_cell(name)
    c = copy.deepcopy(cell.config)
    c["log"]["n_steps"] = 1200
    return harness.Cell(**{**cell.__dict__, "config": c}), 1000


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(card, name):
    cell, steps = _cell(name)
    prog = control.readings(cell, [11, 12, 13], control.program_outputs,
                            steps, card)
    ctrl = control.readings(cell, [11, 12, 13], control.control_outputs,
                            steps, card)
    assert not any(_fails(cell, r) for r in prog), prog
    assert all(_fails(cell, r) for r in ctrl), ctrl
