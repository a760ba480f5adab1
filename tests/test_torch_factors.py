"""K7's plain versions (kernels/factors.lm_linearize_plain,
lm_banded_system_plain, lm_cost_plain: closed-form factor Jacobians,
float64 inside, sums gathered per pose) on the CPU, held to the op-by-op
LM functions of models/pose_graph (_linearize: jacfwd under vmap;
_banded_system; _cost), which the JAX parity tests hold; the rule that
sends the factor work to K7; and the LM with the plain versions patched in.
The kernel itself is held to its plain versions on the card
(tests/test_torch_kernels.py).

Tolerances, on torch_tridiag_cases.k7_gaps' scales. float64: within 1e-12
of the op path. float32: within 1e-5 of the op path run in
float64 on the same float32 inputs, on the same scales. The op path's own
float32 arithmetic is no yardstick there: jacfwd's derivative of
sin(w)/w, (w cos w - sin w) / w^2, cancels to -w^3/3 for small w, so for
1e-6 < |omega| < 1e-2 its float32 theta column is off by up to half
(1.2% of a between block of fixed_97), and its float32 products J_j^T J_i
lose up to 1e-4 of a block (terms near 65 summing to about 0.2); the plain
version, float64 inside and rounded once, stays within 1e-6 of float64.
"""

import pytest
import torch

from lidar_slam_tpu_torch.kernels import factors
from lidar_slam_tpu_torch.models import pose_graph as tpg
from lidar_slam_tpu_torch.utils import tracing
from torch_tridiag_cases import FACTOR_CASES, factor_case, k7_gaps

torch.set_num_threads(1)

CUDA, CPU = torch.device("cuda"), torch.device("cpu")
SMALL = [name for name in FACTOR_CASES if name != "cells"]
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def problems(name, dtype):
    """The op path's _Problem at x, K7's (the plain versions on the CPU),
    and the op path's in float64 on the same inputs; x, x in float64,
    band."""
    x, g, robust, band = factor_case(name, dtype)
    p = tpg._problem(x, g, robust, 1.0)
    x64 = x.double()
    g64 = type(g)(*(t.double() if t.is_floating_point() else t for t in g))
    return (p, tpg._on_kernel(p, x.shape[0]),
            tpg._problem(x64, g64, robust, 1.0), x, x64, band)


def compare(p, pk, p64, x, x64, band, lam=1e-3, pad=True):
    """k7_gaps of K7's plain versions against the op path (the float64 op
    path for float32 inputs)."""
    n, dt = x.shape[0], x.dtype
    Jk, gk = tpg._linearize(x, pk)
    lam_t = torch.tensor(lam, dtype=dt)
    system = tpg._banded_system(pk, Jk, gk, lam_t, n, band, pad)
    ck = tpg._cost(x, pk)
    assert all(t.dtype == dt for t in Jk + (gk, ck) + system)
    assert ck.shape == ()
    ref, x_ref = (p64, x64) if dt is torch.float32 else (p, x)
    J, g = tpg._linearize(x_ref, ref)
    return k7_gaps((Jk, gk), system, ck, (J, g),
                   tpg._banded_system(ref, J, g, lam_t.to(x_ref.dtype), n,
                                      band, pad), tpg._cost(x_ref, ref), band)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", SMALL)
def test_plain_matches_op_path(name, dtype):
    gaps = compare(*problems(name, dtype))
    assert max(gaps.values()) <= TOL[dtype], gaps


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_matches_op_path_at_the_cells_shape(dtype):
    """4,956 poses, 495 fixed-interval loops, 152 live; band 10."""
    gaps = compare(*problems("cells", dtype))
    assert max(gaps.values()) <= TOL[dtype], gaps


@pytest.mark.parametrize("name", ["fixed_205", "huber", "ragged"])
def test_sharded_slice_without_the_prior(name):
    """A rank's factor slice of optimize_sharded (contiguous, the prior
    zeroed, no lam and no tail identity: pad False) through K7's plain
    versions against the op path, float64."""
    p, _, _, x, _, band = problems(name, torch.float64)

    def cut(f, lo, hi):
        return f._replace(fi=f.fi[lo:hi], fj=f.fj[lo:hi], meas=f.meas[lo:hi],
                          weight=None if f.weight is None
                          else f.weight[lo:hi])

    nb, nl = p.btw.fi.shape[0], p.loops.fi.shape[0]
    p = p._replace(inv_prior=p.inv_prior * 0.0,
                   btw=cut(p.btw, nb // 3, 2 * nb // 3),
                   loops=cut(p.loops, nl // 3, nl))
    pk = tpg._on_kernel(p, x.shape[0])
    gaps = compare(p, pk, p, x, x, band, lam=0.0, pad=False)
    assert max(gaps.values()) <= TOL[torch.float64], gaps


def test_index_lists_each_factor_on_both_poses():
    """prepare's pose-to-factor index: each factor once on each of its
    poses, side 0 on fi, side 1 on fj, a pose's entries in the op path's
    order (between-as-i, between-as-j, loop-as-i, loop-as-j)."""
    x, g, _, _ = factor_case("mixed_100")
    fg = tpg._on_kernel(tpg._problem(x, g), x.shape[0]).kernel
    F, nb = fg.fi.shape[0], fg.nb
    assert fg.start[0] == 0 and fg.start[-1] == 2 * F
    seen = []
    for k in range(fg.n):
        ent = fg.entries[fg.start[k]:fg.start[k + 1]].tolist()
        f, side = [e // 2 for e in ent], [e % 2 for e in ent]
        assert all(int((fg.fj if s else fg.fi)[i]) == k
                   for i, s in zip(f, side))
        kind = [2 * (i >= nb) + s for i, s in zip(f, side)]
        assert sorted(zip(kind, f)) == list(zip(kind, f))
        seen += ent
    assert sorted(seen) == list(range(2 * F))


@pytest.mark.parametrize("device", [CUDA, CPU])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.float16])
def test_factor_kernel_path_rule(device, dtype):
    """Only CUDA float32 or float64 poses take K7."""
    want = device.type == "cuda" and dtype in (torch.float32, torch.float64)
    assert tpg.factor_kernel_path(device, dtype) is want


@pytest.fixture
def traced():
    tracing.reset()
    tracing.enable()
    yield
    tracing.disable()
    tracing.reset()


def test_cpu_tensors_take_the_op_path(traced, monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("a CPU LM reached K7's wrapper")

    for name in ("lm_linearize", "lm_banded_system", "lm_cost", "prepare"):
        monkeypatch.setattr(factors, name, no_kernel)
    x, g, _, band = factor_case("fixed_97")
    res = tpg.optimize(x, g, solver="banded", band=band)
    counts = tracing.snapshot()["counts"]
    assert "pose_graph.linearizations_on_kernel" not in counts
    assert counts["pose_graph.iterations"] == res.iterations >= 2


@pytest.mark.parametrize("solver", ["banded", "direct", "cg"])
@pytest.mark.parametrize("name", ["fixed_205", "huber", "cauchy", "ragged",
                                  "one_super_block", "heading_pi"])
def test_lm_with_the_plain_versions_patched_in(name, solver, traced,
                                               monkeypatch):
    """With the rule forced on CPU tensors the LM's factor work runs
    through K7's wrappers, hence its plain versions: one counted
    linearization an iteration, and the op path's LM in float64 (the same
    iterations, the cost within 1e-12 relative, the poses within 1e-9; CG
    within its own stopping noise, 1e-6)."""
    x, g, robust, band = factor_case(name)
    kw = dict(solver=solver, band=band, robust=robust)
    want = tpg.optimize(x, g, **kw)
    tracing.reset()
    monkeypatch.setattr(tpg, "factor_kernel_path", lambda *a: True)
    got = tpg.optimize(x, g, **kw)
    counts = tracing.snapshot()["counts"]
    assert counts["pose_graph.linearizations_on_kernel"] == counts[
        "pose_graph.iterations"] == got.iterations == want.iterations
    assert abs(float(got.cost) - float(want.cost)) <= 1e-12 * max(
        float(want.cost), 1.0)
    tol = 1e-6 if solver == "cg" else 1e-9
    assert float((got.poses - want.poses).abs().max()) <= tol
    assert torch.equal(got.final_lambda, want.final_lambda)


def test_lm_launch_counts_on_the_plain_path(traced, monkeypatch):
    """The wrappers' counts stay 0 for CPU tensors (the plain versions
    launch nothing), and the snapshot carries them."""
    monkeypatch.setattr(tpg, "factor_kernel_path", lambda *a: True)
    x, g, _, band = factor_case("ragged")
    tpg.optimize(x, g, solver="banded", band=band)
    counts = tracing.snapshot()["counts"]
    for name in ("lm_linearize", "lm_banded_system", "lm_cost"):
        assert counts[f"launches.{name}"] == 0


def test_float32_outputs_round_the_float64_values_once():
    """float32 poses: the plain versions' outputs are their float64 values
    on the same inputs, rounded once."""
    x, g, robust, band = factor_case("cauchy", torch.float32)
    fg = tpg._on_kernel(tpg._problem(x, g, robust), x.shape[0]).kernel
    fg64 = fg._replace(**{k: getattr(fg, k).double() for k in (
        "btw_meas", "loop_meas", "loop_weight", "consts")})
    J, gr = factors.lm_linearize_plain(fg, x)
    J64, gr64 = factors.lm_linearize_plain(fg64, x.double())
    assert all(torch.equal(a, b.float()) for a, b in zip(J, J64))
    assert torch.equal(gr, gr64.float())
    assert torch.equal(factors.lm_cost_plain(fg, x),
                       factors.lm_cost_plain(fg64, x.double()).float())
