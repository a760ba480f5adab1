"""The port's probes P1-P9 (kernels/probes.py, run here through their plain
versions) against the JAX package's probe tools run in Pallas interpret
mode on the CPU, bit for bit, on the tools' own inputs at small sizes.

The JAX tools are loaded from tools/ unchanged. pallas_call is wrapped to
pass interpret=True and to record each call's inputs and output (outside
jit, where they are concrete arrays), jax.jit is made the identity and the
device probe stubbed. The tools set JAX's compilation-cache config when
imported or run; a fixture resets it after each import and at the end.
"""

import importlib.util
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from lidar_slam_tpu_torch.kernels import probes
from lidar_slam_tpu_torch.tools import pallas_probe as tpp
from lidar_slam_tpu_torch.tools import scatter_microbench as tsm
from lidar_slam_tpu_torch.tools import vpu_probe as tvp

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = ("jax_compilation_cache_dir",
          "jax_persistent_cache_min_compile_time_secs")
SMALL_U, SMALL_SEG, SMALL_M1 = 4096, 1024, 16  # multiples of CH = 512


@pytest.fixture(scope="module")
def tools_env():
    """(MonkeyPatch, calls, load): pallas_call runs in interpret mode and
    records (kernel, inputs, output) of each call in `calls`; jax.jit is
    the identity and the TPU device probe a stub; load(name) imports a JAX
    tool and resets JAX's config. Restores the config and sys.path."""
    saved = {k: getattr(jax.config, k) for k in CONFIG}
    path = list(sys.path)
    calls = []
    orig = pl.pallas_call

    def reset():
        for k, v in saved.items():
            jax.config.update(k, v)

    def load(name):
        spec = importlib.util.spec_from_file_location(
            f"_jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        reset()
        return mod

    def pallas_call(kernel, *args, **kwargs):
        fn = orig(kernel, *args, interpret=True, **kwargs)

        def run(*inputs):
            copies = [np.array(a) for a in inputs]
            out = fn(*inputs)
            calls.append((kernel, copies, np.array(out)))
            return out

        return run

    import lidar_slam_tpu.utils.profiling as profiling

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", pallas_call)
        mp.setattr(jax, "jit", lambda f=None, **kw: f)
        mp.setattr(profiling, "devices_or_die", lambda *a, **k: [None])
        yield mp, calls, load
    reset()
    sys.path[:] = path


def _bits_equal(got: torch.Tensor, want: np.ndarray):
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.fixture(scope="module")
def jax_pallas_probe(tools_env):
    _, calls, load = tools_env
    tool = load("pallas_probe")
    out = {}
    for name in tpp.KERNELS:
        n = len(calls)
        getattr(tool, name)()
        assert len(calls) == n + 1
        out[name] = calls[-1][1:]
    return out


@pytest.mark.parametrize("name", list(tpp.KERNELS))
def test_pallas_probe_bit_exact(jax_pallas_probe, name):
    """P1-P6: the JAX tool's inputs are the port tool's, and the port's
    plain version gives the JAX kernel's output bit for bit."""
    inputs, want = jax_pallas_probe[name]
    mine = tpp.inputs(name)
    assert len(inputs) == len(mine)
    for a, b in zip(inputs, mine):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    _bits_equal(tpp.call(name, "cpu"), want)
    assert np.count_nonzero(want) > 0


def _jax_probe(tools_env, name, inputs, ch=tpp.CH):
    """The JAX tool's probe `name` run in interpret mode on `inputs` in
    place of its own, with its per-step entry count CH set to `ch` (its
    kernels loop over CH entries a grid step)."""
    mp, _, load = tools_env
    tool = load("pallas_probe")
    recording = pl.pallas_call

    def on_inputs(kernel, *args, **kwargs):
        fn = recording(kernel, *args, **kwargs)
        return lambda *_: fn(*[jax.numpy.asarray(a) for a in inputs])

    with pytest.MonkeyPatch.context() as m:
        m.setattr(tool, "CH", ch)
        m.setattr(pl, "pallas_call", on_inputs)
        return np.asarray(getattr(tool, name)())


def _tile_entries(case: str, tool: str = "v3_dynamic_lane_store"):
    """(xs, ys) int32 arrays of one P2-P4 case ("tool": the inputs of JAX
    tool `tool`, whose P2 takes only xs)."""
    W, H = probes.PROBE_SHAPE
    rng = np.random.default_rng(12)
    if case == "tool":
        return tpp.inputs(tool)
    if case == "hot_tile":  # 3,000 of 4,096 entries on tile (5, 1)
        xs = rng.integers(0, W, 4096).astype(np.int32)
        ys = rng.integers(0, H, 4096).astype(np.int32)
        hot = rng.choice(4096, 3000, replace=False)
        xs[hot] = rng.integers(40, 48, 3000)
        ys[hot] = rng.integers(128, 256, 3000)
        return xs, ys
    if case == "off_grid":  # negative and past the grid in both axes
        return (rng.integers(-40, W + 40, 2000).astype(np.int32),
                rng.integers(-400, H + 400, 2000).astype(np.int32))
    return np.zeros(0, np.int32), np.zeros(0, np.int32)


@pytest.mark.parametrize("case", ["tool", "hot_tile", "off_grid", "empty"])
def test_dynamic_lane_store_design_equals_plain(case):
    """P3's kernel design (a hit count a tile, S_k written once) is its
    plain version (one +1.0 tile add an entry, in order), bit for bit:
    on the tool's entries, a hot tile, entries off the grid on every side
    (dropped by the same floor division) and none."""
    xs, ys = map(torch.from_numpy, _tile_entries(case))
    want = probes.dynamic_lane_store_plain(xs, ys)
    _bits_equal(probes.dynamic_lane_store_design(xs, ys), want.numpy())
    inside = int(((xs >= 0) & (xs < 64) & (ys >= 0) & (ys < 256)).sum())
    assert float(want.sum()) == 1024 * inside
    if case == "hot_tile":
        assert float(want[40, 128]) >= 3000


@pytest.mark.parametrize("case", ["tool", "hot_tile"])
def test_dynamic_lane_store_design_equals_jax(tools_env, case):
    """P3's kernel design against the JAX tool's v3 in interpret mode, on
    the tool's 64 entries and on 4,096 entries with 3,000 on one tile (the
    tool's kernel then steps through 2,048 entries a grid step)."""
    xs, ys = _tile_entries(case)
    want = _jax_probe(tools_env, "v3_dynamic_lane_store", (xs, ys),
                      len(xs) // 2)
    got = probes.dynamic_lane_store_design(torch.from_numpy(xs),
                                           torch.from_numpy(ys))
    _bits_equal(got, want)


@pytest.mark.parametrize("case", ["tool", "hot_tile", "off_grid", "empty"])
def test_dynamic_store_design_equals_plain(case):
    """P2's kernel design (P3's with every entry on lane tile 0: a hit
    count a row band, S_k written once) is its plain version (one +1.0
    tile add an entry, in order), bit for bit, on the cases of P3's."""
    xs = torch.from_numpy(_tile_entries(case, "v2_dynamic_store")[0])
    want = probes.dynamic_store_plain(xs)
    _bits_equal(probes.dynamic_store_design(xs), want.numpy())
    assert float(want.sum()) == 1024 * int(((xs >= 0) & (xs < 64)).sum())
    assert not want[:, 128:].any()
    if case == "hot_tile":
        assert float(want[40, 0]) >= 3000


@pytest.mark.parametrize("case", ["tool", "hot_tile", "off_grid", "empty"])
def test_masked_tile_design_equals_plain(case):
    """P4's kernel design (a hit count a cell, the k-fold sum of -1.386
    written once) is its plain version (one add an entry, in order), bit
    for bit, on the cases of P3's."""
    xs, ys = map(torch.from_numpy, _tile_entries(case, "v4_masked_tile"))
    want = probes.masked_tile_plain(xs, ys)
    _bits_equal(probes.masked_tile_design(xs, ys), want.numpy())
    inside = (xs >= 0) & (xs < 64) & (ys >= 0) & (ys < 256)
    cells = (xs.long() * 256 + ys)[inside].unique()
    assert int((want != 0).sum()) == len(cells)
    if case == "hot_tile":  # most cells of the hot tile hit twice or more
        assert int((want[40:48, 128:] < -2.7).sum()) > 500


@pytest.mark.parametrize("case", ["tool", "hot_tile"])
def test_dynamic_store_design_equals_jax(tools_env, case):
    """P2's kernel design against the JAX tool's v2 in interpret mode, on
    the tool's 64 entries and on 4,096 with 3,000 in one row band."""
    xs = _tile_entries(case, "v2_dynamic_store")[0]
    want = _jax_probe(tools_env, "v2_dynamic_store", (xs,), len(xs) // 2)
    _bits_equal(probes.dynamic_store_design(torch.from_numpy(xs)), want)


@pytest.mark.parametrize("case", ["tool", "hot_tile"])
def test_masked_tile_design_equals_jax(tools_env, case):
    """P4's kernel design against the JAX tool's v4 in interpret mode (its
    masked tile adds 0.0 off the mask), on the tool's 64 entries and on
    4,096 with 3,000 on one tile."""
    xs, ys = _tile_entries(case, "v4_masked_tile")
    want = _jax_probe(tools_env, "v4_masked_tile", (xs, ys), len(xs) // 2)
    got = probes.masked_tile_design(torch.from_numpy(xs),
                                    torch.from_numpy(ys))
    _bits_equal(got, want)


@pytest.fixture(scope="module")
def ones_folds():
    """S_k for k = 0 .. 2^25: the sequential float32 fold of 1.0 (numpy's
    add.accumulate adds in order, in float32)."""
    s = np.ones(2**25 + 1, np.float32)
    s[0] = 0.0
    return np.add.accumulate(s, dtype=np.float32)


@pytest.mark.parametrize("k", [0, 1, 2**24 - 1, 2**24, 2**24 + 1, 2**25])
def test_ones_fold_is_the_sequential_fold(ones_folds, k):
    """The closed form P3's kernel writes, min(k, 2^24), is the k-fold
    in-order float32 sum of 1.0 (the plain version's adds)."""
    got = probes.ones_fold(torch.tensor([k]))
    assert got.dtype == torch.float32
    assert got.numpy().view(np.int32)[0] == ones_folds[k:k + 1].view(
        np.int32)[0]
    assert float(got[0]) == min(k, 2**24)


@pytest.mark.parametrize("k", [0, 1, 2, 1000, 100_000])
def test_k_fold_is_the_sequential_fold(k):
    """The sum P4's and P8's kernels write for a cell hit k times
    (k_fold_sum), as k_fold tables it, is numpy's in-order float32
    accumulate of -1.386."""
    adds = np.full(k + 1, -probes.LOG4, np.float32)
    adds[0] = 0.0
    want = np.add.accumulate(adds, dtype=np.float32)[k:]
    got = probes.k_fold(torch.tensor([k]), -probes.LOG4)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def _order_sensitive(case: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(13)
    if case == "alternating":  # 1e8 + 1 rounds to 1e8: the fold gives 1.0
        return np.tile(np.float32([1e8, 1.0, -1e8, 1.0]), n // 4)
    if case == "mixed":  # signs and magnitudes from 1e-3 to 1e8
        return (rng.choice([-1.0, 1.0], n)
                * 10.0 ** rng.uniform(-3, 8, n)).astype(np.float32)
    return np.float32(rng.permutation(  # large values cancelling late
        np.concatenate([np.full(n // 2, 3e7), np.full(n // 2, -3e7)])
        + rng.uniform(-1, 1, n)))


@pytest.mark.parametrize("case", ["alternating", "mixed", "cancelling"])
@pytest.mark.parametrize("n", [32, 4096])
def test_scalar_sum_equals_jax_in_order(tools_env, case, n):
    """P5's plain version (the kernel's in-order fold) against the JAX
    tool's v5 in interpret mode, on values whose float32 sum depends on
    the order of the adds."""
    xs = _order_sensitive(case, n)
    want = _jax_probe(tools_env, "v5_vmem_scalar_read", (xs,), n)
    _bits_equal(probes.scalar_sum(torch.from_numpy(xs)), want)
    pairwise = float(torch.from_numpy(xs).sum())
    assert want.shape == (1, 1)
    if case == "alternating":
        assert float(want[0, 0]) == 1.0 and pairwise != 1.0


def _smem_entries(case: str) -> np.ndarray:
    """P1's entries: the JAX tool's, 4,096 order-sensitive ones, or 64
    entries of -0.0 (the fold from +0.0 gives +0.0, a fold that started
    from the first entry -0.0)."""
    if case == "tool":
        return tpp.inputs("v1_smem_stream")[0]
    if case == "negative_zero":
        return np.full(64, -0.0, np.float32)
    if case == "empty":
        return np.zeros(0, np.float32)
    return _order_sensitive(case, 4096)


SMEM_CASES = ["tool", "alternating", "mixed", "cancelling", "negative_zero"]


@pytest.mark.parametrize("case", SMEM_CASES + ["empty"])
def test_smem_stream_design_equals_plain(case):
    """P1's kernel design (one in-order fold written to every tile cell)
    against its plain version (every add of every tile cell, in order), bit
    for bit; on two of the order-sensitive cases a tree sum gives another
    tile."""
    xs = torch.from_numpy(_smem_entries(case))
    want = probes.smem_stream_plain(xs)
    got = probes.smem_stream_design(xs)
    _bits_equal(got, want.numpy())
    assert not want[probes.TS:].any() and not want[:, probes.LANES:].any()
    if case in ("alternating", "mixed"):
        assert float(xs.sum()) != float(want[0, 0])
    if case == "negative_zero":
        assert not torch.signbit(want).any()
    if case == "alternating":
        assert float(want[7, 127]) == 1.0


@pytest.mark.parametrize("case", SMEM_CASES)
def test_smem_stream_design_equals_jax(tools_env, case):
    """P1's kernel design against the JAX tool's v1 in interpret mode (two
    grid steps of n / 2 entries), bit for bit."""
    xs = _smem_entries(case)
    want = _jax_probe(tools_env, "v1_smem_stream", (xs,), len(xs) // 2)
    _bits_equal(probes.smem_stream_design(torch.from_numpy(xs)), want)
    assert want.shape == probes.PROBE_SHAPE


@pytest.fixture(scope="module")
def jax_scatter(tools_env):
    return tools_env[2]("scatter_microbench")


def test_tile_rmw_bit_exact(jax_scatter):
    """P7: u ray-shaped updates added in order."""
    want_in = jax_scatter.make_updates(SMALL_U, 0)
    mine = tsm.make_updates(SMALL_U, 0)
    for a, b in zip(want_in, mine):
        np.testing.assert_array_equal(np.asarray(a), b)
    want = np.asarray(jax_scatter.pallas_rmw(SMALL_U)(*want_in))
    got = probes.tile_rmw(*map(torch.from_numpy, mine))
    _bits_equal(got, want)
    # the first steps of 1,081 rays from one centre: about 4,000 adds on
    # a few dozen cells, so the order of the adds shows in the sums
    flat = mine[0].astype(np.int64) * tsm.H + mine[1]
    assert np.count_nonzero(want) == len(np.unique(flat)) < 100


def test_segment_rmw_bit_exact(jax_scatter):
    """P8: per segment, the cells of its tile on the closed-form line."""
    args = tsm.seg_args(SMALL_SEG, 0)
    want = np.asarray(jax_scatter.pallas_seg(SMALL_SEG)(*args))
    got = probes.segment_rmw(*map(torch.from_numpy, args))
    _bits_equal(got, want)
    assert np.count_nonzero(want) > 1000 and want.min() < -1.386


@pytest.fixture(scope="module")
def jax_vpu_calls(tools_env):
    """vpu_probe.main() at m1 = 16 with one rep: three calls per mode
    (warm-up and 8 reps, then 40 reps) on seeded words and grids."""
    mp, calls, load = tools_env
    tool = load("vpu_probe")
    mp.setattr(sys, "argv", ["vpu_probe.py", "--m1", str(SMALL_M1),
                             "--reps", "1", "--modes",
                             ",".join(probes.VPU_MODES)])
    n = len(calls)
    tool.main()  # sets the cache config again before it compiles
    out = {}
    for kernel, inputs, grid in calls[n:]:
        free = dict(zip(kernel.__code__.co_freevars,
                        (c.cell_contents for c in kernel.__closure__)))
        out.setdefault(free["mode"], []).append(
            (free["n_pairs"], free["reps"], inputs, grid))
    return out


@pytest.mark.parametrize("mode", probes.VPU_MODES)
def test_vpu_loop_bit_exact(jax_vpu_calls, mode):
    """P9: every call of the mode, on the carried random grid."""
    runs = jax_vpu_calls[mode]
    assert [(n, r) for n, r, _, _ in runs] == [(SMALL_M1, 8), (SMALL_M1, 8),
                                               (SMALL_M1, 40)]
    rays = mode in ("ray1", "ray2")
    for n_pairs, reps, inputs, want in runs:
        words, grid = inputs[0], inputs[-1]
        np.testing.assert_array_equal(words,
                                      tvp.words_for(n_pairs, 10, rays=rays))
        got = probes.vpu_loop(torch.from_numpy(words),
                              torch.from_numpy(grid.copy()), n_pairs, mode,
                              reps)
        _bits_equal(got, want)
        assert np.count_nonzero(want != grid) > 100


@pytest.mark.parametrize("name", ["v1_smem_stream", "v2_dynamic_store",
                                  "v3_dynamic_lane_store", "v4_masked_tile",
                                  "tile_rmw", "segment_rmw"])
def test_adds_give_the_probe(name):
    """probes.adds lists a probe's adds in order: one index_add_ of them
    into a zero grid (in order on the CPU) is the probe's output, the
    library call that phase [10] of chip_smoke.py times."""
    if name == "tile_rmw":
        fn, args = probes.tile_rmw, tsm.make_updates(SMALL_U, 0)
    elif name == "segment_rmw":
        fn, args = probes.segment_rmw, tsm.seg_args(SMALL_SEG, 0)
    else:
        fn, args = tpp.KERNELS[name], tpp.inputs(name)
    args = [torch.from_numpy(a) for a in args]
    flat, vals = probes.adds(fn, *args)
    got = tsm.index_add(flat, vals, fn.shape)
    _bits_equal(got, fn(*args).numpy())


@pytest.mark.parametrize("mode", probes.VPU_MODES)
def test_vpu_adds_give_the_loop(mode):
    """P9: the cells each visit writes (vpu_adds), added in order on the
    carried grid, are the plain loop (which adds 0.0 off the mask)."""
    words = torch.from_numpy(tvp.words_for(SMALL_M1, 3,
                                           rays=mode in ("ray1", "ray2")))
    grid = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (tvp.GRID, tvp.GRID)).astype(np.float32))
    adds = list(probes.vpu_adds(words, SMALL_M1, mode, grid.shape)) * 2
    flat = torch.cat([f for f, _ in adds])
    want = probes.vpu_loop(words, grid.clone(), SMALL_M1, mode, 2)
    got = grid.clone().view(-1).index_add_(
        0, flat, torch.cat([v for _, v in adds])).view(grid.shape)
    _bits_equal(got, want.numpy())
    assert len(flat) > 0


def test_cells_per_visit():
    """The cells a P9 visit writes: the whole (64, 128) tile for rmw, the
    rows [5, 42] and [9, 60] of vec's two fixed visits, a random span for
    full, and a ray's few cells for the ray modes."""
    def cells(mode, m1=64):
        rays = mode in ("ray1", "ray2")
        return tvp.cells_per_visit(torch.from_numpy(
            tvp.words_for(m1, 10, rays=rays)), m1, mode)

    assert cells("rmw") == 64 * 128
    assert cells("vec") == (38 + 52) * 128 / 2
    assert 1000 < cells("full") == cells("fullv") < 5000
    assert 0 < cells("ray1") < 64 and 0 < cells("ray2") < 64


def test_wrappers_take_plain_version_on_cpu():
    """On CPU tensors no kernel is launched, and a bad P9 call raises
    before any route is taken."""
    before = [w.launches for w in probes.WRAPPERS]
    tpp.call("v4_masked_tile", "cpu")
    probes.full_grid("cpu")
    args = tsm.seg_args(64, 1)
    probes.segment_rmw(*map(torch.from_numpy, args))
    assert [w.launches for w in probes.WRAPPERS] == before
    with pytest.raises(ValueError, match="mode"):
        probes.vpu_loop(torch.zeros((4, 8), dtype=torch.int32),
                        torch.zeros((512, 512)), 8, "nope", 1)
    with pytest.raises(ValueError, match="words must be"):
        probes.vpu_loop(torch.zeros((4, 8), dtype=torch.int32),
                        torch.zeros((512, 512)), 8, "ray1", 1)


def test_plain_adds_in_update_order():
    """Three updates of one cell in two orders: float32 rounding makes the
    order visible, and the plain version keeps it."""
    xs = torch.tensor([5, 5, 5], dtype=torch.int32)
    ys = torch.tensor([7, 7, 7], dtype=torch.int32)
    big, small = 1e8, 3.0
    a = probes.tile_rmw(xs, ys, torch.tensor([big, small, -big]))
    b = probes.tile_rmw(xs, ys, torch.tensor([big, -big, small]))
    assert float(a[5, 7]) == 0.0 and float(b[5, 7]) == small
    # cells outside the grid are dropped
    out = probes.tile_rmw(torch.tensor([-1, 2000], dtype=torch.int32),
                          torch.tensor([3, 3], dtype=torch.int32),
                          torch.ones(2))
    assert float(out.abs().sum()) == 0.0


@pytest.mark.parametrize("tool", ["pallas_probe", "scatter_microbench",
                                  "vpu_probe", "host_split"])
def test_probe_tools_refuse_a_host_without_cuda(tool):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the refusal is not reachable")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m",
                          f"lidar_slam_tpu_torch.tools.{tool}"],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=120)
    assert out.returncode != 0
    assert "needs a CUDA GPU" in out.stderr
    assert out.stdout == ""


@pytest.mark.parametrize("outputs", [1, 2])
def test_host_split_times_the_entry_on_the_wrappers_arguments(outputs):
    """tools/host_split records the arguments and stream one wrapper call
    passed its build.Entry, then calls the entry's function alone on them,
    and allocates what the wrapper returned; the entry is left as it was."""
    from lidar_slam_tpu_torch.kernels import build
    from lidar_slam_tpu_torch.tools import host_split

    seen = []
    fake = lambda *args: seen.append(args) or 0  # noqa: E731
    entry = build.Entry("slam_probe_fake")
    entry._fn, entry._get_device = fake, lambda: 0
    entry._raw_stream = lambda index: 77 + index
    made = (torch.zeros((3, 2)), torch.zeros(4, dtype=torch.int32))

    def call():
        entry(0, 5, 6)
        return made[0] if outputs == 1 else made

    empty, alone = host_split._parts(call, entry, torch.device("cpu"))
    assert entry._fn is fake and seen == [(5, 6, 77)] * 2
    assert alone() == 0 and seen[-1] == (5, 6, 77) and len(seen) == 3
    got = empty()
    got = (got,) if outputs == 1 else got
    assert [(t.shape, t.dtype) for t in got] == [
        (t.shape, t.dtype) for t in made[:outputs]]
