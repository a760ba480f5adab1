"""The design of the probe P9's Hopper kernel, in PyTorch on the CPU
(kernels/probes.vpu_owner_lists, vpu_loop_design), bit for bit against the
plain loop (vpu_loop_plain) and the JAX tool's kernel in Pallas interpret
mode.

A block of the kernel owns 8 x 128 cells of one (64, 128) tile position,
keeps them in registers and walks, in order and every repetition, the
visits its filter keeps: those on its tile whose mask band meets its rows.
The cases cover the six modes; a 600 x 700 grid whose tile positions lie
partly and wholly outside it; pair counts that are no power of two and a
ray table that wraps; every visit on one tile; and no pairs or no
repetitions.
"""

import numpy as np
import pytest
import torch

from lidar_slam_tpu_torch.kernels import probes
from lidar_slam_tpu_torch.tools import vpu_probe as tvp
from tests.test_torch_probes import jax_vpu_calls, tools_env  # noqa: F401
from torch_vpu_tiles import retile

torch.set_num_threads(1)

RAYS = ("ray1", "ray2")
# tile rows [0, 12) and lane tiles [0, 8) on a 600 x 700 grid: rows 600-639
# and lanes 700-767 of the last tile positions lie outside it, tile rows 10
# and 11 and lane tiles 6 and 7 wholly outside
OUTSIDE = (600, 700), ((0, 12), (0, 8))
HOT = (tvp.GRID, tvp.GRID), ((3, 4), (2, 3))  # every visit on tile (3, 2)


def _case(mode, n_pairs, seed, where=((tvp.GRID, tvp.GRID), None)):
    """(words, grid) CPU tensors: the tool's word table for n_pairs (its
    tiles drawn from where[1], the tool's by default) and a random grid of
    shape where[0]."""
    shape, tiles = where
    words = tvp.words_for(n_pairs, seed, rays=mode in RAYS)
    if tiles is not None:
        words = retile(words, tiles, seed)
    words = torch.from_numpy(words)
    grid = torch.from_numpy(np.random.default_rng(seed + 1).normal(
        0, 1, shape).astype(np.float32))
    return words, grid


def _same_bits(got: torch.Tensor, want: torch.Tensor):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _design_equals_plain(words, grid, n_pairs, mode, reps):
    want = probes.vpu_loop_plain(words, grid.clone(), n_pairs, mode, reps)
    got = probes.vpu_loop_design(words, grid.clone(), n_pairs, mode, reps)
    _same_bits(got, want)
    return int((want != grid).sum())


@pytest.mark.parametrize("mode", probes.VPU_MODES)
def test_vpu_design_bit_exact(mode):
    """The tool's words and grid, 256 pairs x 2 repetitions."""
    assert _design_equals_plain(*_case(mode, 256, 3), 256, mode, 2) > (
        1000 if mode not in RAYS else 100)


@pytest.mark.parametrize("mode", probes.VPU_MODES)
def test_vpu_design_grid_partly_outside(mode):
    """A 600 x 700 grid (no multiple of the tile) and visits on tile
    positions partly and wholly outside it: those cells are dropped."""
    words, grid = _case(mode, 300, 5, OUTSIDE)
    assert _design_equals_plain(words, grid, 300, mode, 2) > (
        1000 if mode not in RAYS else 50)
    lists = probes.vpu_owner_lists(words, 300, mode, grid.shape)
    assert (9, 5, 2) in lists and (9, 5, 3) not in lists  # rows 592-599
    assert len(lists) == 10 * 6 * 8 - 6 * 5


@pytest.mark.parametrize("mode,n_pairs", [("ray2", 3000), ("ray2", 4100)])
def test_vpu_design_pairs_no_power_of_two(mode, n_pairs):
    """Pair counts that are no power of two: the ray modes index their
    table at i & (min(n_pairs, 4096) - 1), so 3,000 pairs read a sparse
    set of columns and 4,100 wrap at 4,096."""
    words, grid = _case(mode, n_pairs, 7, OUTSIDE)
    assert _design_equals_plain(words, grid, n_pairs, mode, 1) > 50


@pytest.mark.parametrize("mode", ["full", "fullv", "ray2"])
def test_vpu_design_hot_tile(mode):
    """Every visit on one tile: its eight owners take every visit, the
    rest of the grid stays as it was."""
    words, grid = _case(mode, 400, 9, HOT)
    assert _design_equals_plain(words, grid, 400, mode, 2) > 100
    lists = probes.vpu_owner_lists(words, 400, mode, grid.shape)
    busy = {o for o, v in lists.items() if len(v)}
    assert busy and all(o[:2] == (3, 2) for o in busy)


@pytest.mark.parametrize("n_pairs,reps", [(0, 3), (64, 0)])
def test_vpu_design_nothing_to_do(n_pairs, reps):
    """No pairs or no repetitions: the grid keeps every bit."""
    for mode in probes.VPU_MODES:
        words, grid = _case(mode, max(n_pairs, 1), 11)
        got = probes.vpu_loop_design(words, grid.clone(), n_pairs, mode, reps)
        _same_bits(got, grid)
        _same_bits(probes.vpu_loop_plain(words, grid.clone(), n_pairs, mode,
                                         reps), grid)


@pytest.mark.parametrize("mode", probes.VPU_MODES)
def test_vpu_owner_lists_hold_every_visit_that_writes(mode):
    """An owner's list is in visit order and holds every visit that writes
    one of its cells (the filter may keep a visit that writes none)."""
    words, grid = _case(mode, 200, 13, OUTSIDE)
    W, H = grid.shape
    lists = probes.vpu_owner_lists(words, 200, mode, grid.shape)
    for v in lists.values():
        assert bool((v[1:] > v[:-1]).all())
    kept = {(o, int(i)) for o, v in lists.items() for i in v}
    s = torch.arange(probes.VPU_TS)[:, None]
    l = torch.arange(probes.LANES)[None, :]
    wrote = 0
    for i, (rt, lt, delta) in enumerate(probes.vpu_visits(words, 200, mode)):
        on = (delta != 0) & (rt + s < W) & (lt + l < H)
        for k in set((s.expand_as(on)[on] // probes.VPU_OWNER_ROWS).tolist()):
            assert ((rt // probes.VPU_TS, lt // probes.LANES, k), i) in kept
            wrote += 1
    assert wrote > 100


@pytest.mark.parametrize("mode", probes.VPU_MODES)
def test_vpu_design_matches_jax(jax_vpu_calls, mode):  # noqa: F811
    """Every call of the JAX tool (16 pairs at 8 and 40 repetitions), on
    its carried random grid."""
    for n_pairs, reps, inputs, want in jax_vpu_calls[mode]:
        words, grid = inputs[0], inputs[-1]
        got = probes.vpu_loop_design(torch.from_numpy(words),
                                     torch.from_numpy(grid.copy()), n_pairs,
                                     mode, reps).numpy()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        assert np.count_nonzero(want != grid) > 100
