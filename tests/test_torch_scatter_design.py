"""The designs of the probes P7 and P8's Hopper kernels, in PyTorch on the
CPU (kernels/probes.tile_rmw_design, tile_rmw_lists, segment_rmw_design),
bit for bit against their plain versions and, for P8, the JAX tool's
pallas_seg in Pallas interpret mode.

P7: a stable partition of the updates by owner tile, then by cell, and
each cell's run summed in order; it must keep update order, so the inputs
include one cell hit 5,000 times with values of mixed sign and magnitude.
P8: hit counts per cell, then the k-fold sum of -1.386.
"""

import numpy as np
import pytest
import torch

from lidar_slam_tpu_torch.kernels import probes
from lidar_slam_tpu_torch.tools import scatter_microbench as tsm
from tests.test_torch_probes import tools_env  # noqa: F401 (fixture)

torch.set_num_threads(1)

W, H = probes.GRID_SHAPE


def _same_bits(got: torch.Tensor, want: torch.Tensor):
    assert got.shape == want.shape == probes.GRID_SHAPE
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _updates(case: str):
    """(xs, ys, vs) CPU tensors of one P7 case."""
    rng = np.random.default_rng(11)
    if case == "tool":
        arrays = tsm.make_updates(tsm.UPDATES[0], 0)
    elif case == "hot_cell":
        # 5,000 adds on one cell among 20,000 updates; values of mixed sign
        # and magnitude, so the order of the adds shows in the sum
        u = 20_000
        xs = rng.integers(0, W, u).astype(np.int32)
        ys = rng.integers(0, H, u).astype(np.int32)
        hot = rng.choice(u, 5000, replace=False)
        xs[hot], ys[hot] = 601, 300
        vs = (rng.choice([-1.0, 1.0], u)
              * 10.0 ** rng.uniform(-3, 3, u)).astype(np.float32)
        arrays = xs, ys, vs
    elif case == "random_outside":
        u = 50_000
        arrays = (rng.integers(-20, W + 20, u).astype(np.int32),
                  rng.integers(-20, H + 20, u).astype(np.int32),
                  rng.normal(0, 1e3, u).astype(np.float32))
    elif case == "rays":  # the tool's ray-shaped updates, another seed
        arrays = tsm.make_updates(4096, 3)
    elif case == "single_tile":  # 30,000 updates on one (8, 128) owner
        u = 30_000
        arrays = (rng.integers(600, 608, u).astype(np.int32),
                  rng.integers(512, 640, u).astype(np.int32),
                  rng.normal(0, 1e2, u).astype(np.float32))
    elif case == "outside":  # every update outside the grid
        u = 20_000
        arrays = (rng.integers(W, W + 100, u).astype(np.int32),
                  rng.integers(-50, H, u).astype(np.int32),
                  rng.normal(0, 1, u).astype(np.float32))
    elif case == "signed_zeros":  # +-0.0 among +-1.5 on a 4 x 4 patch
        u = 20_000
        arrays = (rng.integers(300, 304, u).astype(np.int32),
                  rng.integers(700, 704, u).astype(np.int32),
                  rng.choice(np.float32([-0.0, 0.0, 1.5, -1.5]), u))
    else:  # empty
        arrays = (np.zeros(0, np.int32), np.zeros(0, np.int32),
                  np.zeros(0, np.float32))
    return tuple(map(torch.from_numpy, arrays))


@pytest.mark.parametrize("case", ["tool", "hot_cell", "random_outside",
                                  "empty", "rays", "single_tile", "outside",
                                  "signed_zeros"])
def test_tile_rmw_design_bit_exact(case):
    args = _updates(case)
    want = probes.tile_rmw_plain(*args)
    _same_bits(probes.tile_rmw_design(*args), want)
    if case == "hot_cell":
        # the same adds in reverse order give another sum: order shows
        rev = probes.tile_rmw_plain(*(a.flip(0) for a in args))
        assert float(rev[601, 300]) != float(want[601, 300])
    assert bool(want.any()) == (case not in ("empty", "outside"))


@pytest.mark.parametrize("chunk", [512, probes.TILE_RMW_CHUNK])
def test_tile_rmw_lists_in_update_order(chunk):
    """Each owner's list is exactly the in-grid updates of its tile, in
    update order (a brute-force filter of the updates), across chunks."""
    xs, ys, vs = _updates("random_outside")
    bounds, cells, vals = probes.tile_rmw_lists(xs, ys, vs, chunk=chunk)
    OR, OC = probes.TILE_RMW_OWNER
    OH = -(-H // OC)
    assert bounds[0] == 0 and bool((bounds[1:] >= bounds[:-1]).all())
    ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    assert int(bounds[-1]) == int(ok.sum()) > 40_000
    x, y = xs.long(), ys.long()
    o = torch.where(ok, x // OR * OH + y // OC, -1)
    for own in [0, 1, OH, len(bounds) // 2, len(bounds) - 2]:
        lst = slice(int(bounds[own]), int(bounds[own + 1]))
        mine = (o == own).nonzero().squeeze(1)
        assert len(mine) > 0 or own == len(bounds) - 2
        assert torch.equal(cells[lst], (x % OR * OC + y % OC)[mine])
        assert torch.equal(vals[lst], vs[mine])


def test_tile_rmw_lists_ignore_the_chunk():
    """The chunk only splits the counting: any chunk gives one partition."""
    args = _updates("tool")
    want = probes.tile_rmw_lists(*args)
    for chunk in (1024, 100_000):
        got = probes.tile_rmw_lists(*args, chunk=chunk)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def _segments(case: str, n: int):
    """(x8, yl, a, b) int32 numpy arrays of one P8 case."""
    rng = np.random.default_rng(12)
    if case == "aligned":
        return tsm.seg_args(n, 3)
    if case == "unaligned":
        # offsets off the (8, 128) grid, still inside the grid (the JAX
        # kernel slices a whole tile), negative slopes and intercepts
        return (rng.integers(0, W - 8, n).astype(np.int32),
                rng.integers(0, H - 128, n).astype(np.int32),
                rng.integers(-1024, 1024, n).astype(np.int32),
                rng.integers(-8192, 8192, n).astype(np.int32))
    # single tile: every segment on one tile, 10 line shapes, so each
    # cell of a line is hit about n / 10 times
    k = rng.integers(0, 10, n)
    return (np.full(n, 600, np.int32), np.full(n, 512, np.int32),
            (100 * k + 1).astype(np.int32), (700 * k).astype(np.int32))


@pytest.mark.parametrize("case", ["aligned", "unaligned", "single_tile"])
def test_segment_rmw_design_matches_plain(case):
    args = tuple(map(torch.from_numpy, _segments(case, 5000)))
    want = probes.segment_rmw_plain(*args)
    _same_bits(probes.segment_rmw_design(*args), want)
    assert int((want != 0).sum()) > (90 if case == "single_tile" else 1000)


def test_segment_rmw_design_out_of_grid():
    """Segments partly or wholly outside the grid drop those cells."""
    rng = np.random.default_rng(13)
    n = 5000
    args = tuple(torch.as_tensor(a, dtype=torch.int32) for a in (
        rng.integers(-10, W, n), rng.integers(-100, H, n),
        rng.integers(-1024, 1024, n), rng.integers(-8192, 8192, n)))
    _same_bits(probes.segment_rmw_design(*args), probes.segment_rmw_plain(
        *args))
    far = torch.full((4,), 5000, dtype=torch.int32)
    assert not probes.segment_rmw_design(far, far, far, far).any()


@pytest.fixture(scope="module")
def jax_scatter(tools_env):  # noqa: F811
    return tools_env[2]("scatter_microbench")


@pytest.mark.parametrize("case", ["aligned", "unaligned", "single_tile"])
def test_segment_rmw_design_matches_jax(jax_scatter, case):
    """The JAX tool's pallas_seg (a chunk of 512 segments a grid step) in
    interpret mode."""
    arrays = _segments(case, 1024)
    want = np.asarray(jax_scatter.pallas_seg(1024)(*arrays))
    got = probes.segment_rmw_design(*map(torch.from_numpy, arrays)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert want.min() < (-5 * 1.386 if case == "single_tile" else -1.386)
