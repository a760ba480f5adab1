"""K6's plain version (kernels/tridiag.block_tridiag_solve_plain: the
kernel's SPIKE split, Gauss-Jordan block inverses and float64 arithmetic)
on the CPU, held to the op-by-op models/pose_graph.block_tridiag_solve in
float64 and to an independent LAPACK solve of the assembled system; the
rule that sends a solve to K6; and the LM's iteration counters. The
kernel itself is held to its plain version on the card
(tests/test_torch_kernels.py)."""

import numpy as np
import pytest
import scipy.linalg
import torch

from lidar_slam_tpu_torch.kernels import tridiag
from lidar_slam_tpu_torch.models import pose_graph as tpg
from lidar_slam_tpu_torch.utils import tracing
from torch_tridiag_cases import chain_graph, spd_chain

torch.set_num_threads(1)

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


def lapack_solve(A, O, R):
    """T X = R by numpy.linalg.solve on the dense T where it is small, by
    LAPACK's banded Cholesky (scipy.linalg.solveh_banded, lower storage of
    bandwidth 2b - 1) where the dense T would not fit in a test's memory."""
    n, b, m = R.shape
    N = n * b
    if N <= 3000:
        T = np.zeros((N, N))
        for i in range(n):
            T[i * b:(i + 1) * b, i * b:(i + 1) * b] = A[i]
        for i in range(n - 1):
            T[(i + 1) * b:(i + 2) * b, i * b:(i + 1) * b] = O[i]
            T[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = O[i].T
        return np.linalg.solve(T, R.reshape(N, m)).reshape(n, b, m)
    band = np.zeros((2 * b, N))  # band[d, j] = T[j + d, j]
    for i in range(n):
        for d in range(b):
            band[d, i * b:i * b + b - d] = np.diagonal(A[i], -d)
    for i in range(n - 1):
        for r in range(b):  # T[(i+1)b + r, ib + c] = O[i][r, c]
            for c in range(b):
                band[b + r - c, i * b + c] = O[i][r, c]
    return scipy.linalg.solveh_banded(band, R.reshape(N, m),
                                      lower=True).reshape(n, b, m)


@pytest.mark.parametrize("n,b,m,q", [
    (1, 3, 2, 64),       # one block
    (9, 3, 2, 64),       # Thomas only: n <= 2q is one segment of n
    (64, 5, 3, 32),      # Thomas only at n = 2q
    (150, 3, 2, 8),      # SPIKE, a ragged last segment
    (77, 6, 8, 8),       # SPIKE, ragged, wider blocks
    (496, 30, 1, 32),    # the offline cells' banded solve
    (700, 3, 61, 64),    # direct_solve's shape: b = 3, m = 1 + 3L
])
def test_plain_matches_op_by_op_and_lapack(n, b, m, q):
    """float64: within 1e-12 of the op-by-op solve (the same split and
    recurrences; the inverses by Gauss-Jordan instead of LU or the
    adjugate) and within 1e-10 of LAPACK's solve of the whole system."""
    A, O, R = spd_chain(n, b, m, seed=n + b)
    got = tridiag.block_tridiag_solve_plain(*map(torch.from_numpy, (A, O, R)),
                                            q=q)
    assert got.dtype == torch.float64 and got.shape == (n, b, m)
    ops = tpg.block_tridiag_solve(*map(torch.from_numpy, (A, O, R)), q=q)
    np.testing.assert_allclose(got.numpy(), ops.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.numpy(), lapack_solve(A, O, R), rtol=0,
                               atol=1e-10)


def test_plain_keeps_float32_and_computes_in_float64():
    """float32 inputs come back float32: the float64 solution of the
    float32 system, rounded once."""
    A, O, R = (torch.from_numpy(a).float()
               for a in spd_chain(150, 6, 2, seed=1))
    got = tridiag.block_tridiag_solve_plain(A, O, R, q=8)
    want = tridiag.block_tridiag_solve_plain(A.double(), O.double(),
                                             R.double(), q=8)
    assert got.dtype == torch.float32
    assert torch.equal(got, want.float())


def test_segments():
    assert tridiag.segments(64, 32) == (64, 1)
    assert tridiag.segments(65, 32) == (32, 3)
    assert tridiag.segments(496, 32) == (32, 16)
    assert tridiag.segments(4956, 64) == (64, 78)
    with pytest.raises(ValueError, match="q >= 2"):
        tridiag.segments(3, 1)


@pytest.mark.parametrize("device", [CUDA, CPU])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.float16])
@pytest.mark.parametrize("b", [3, 30, 32, 33])
def test_kernel_path_rule(device, dtype, b):
    """Only CUDA float32 or float64 blocks at most 32 wide take K6; CPU
    tensors and wider blocks stay op by op."""
    want = (device.type == "cuda" and dtype in (torch.float32, torch.float64)
            and b <= 32)
    assert tpg.kernel_path(device, dtype, b) is want


def test_cpu_tensors_solve_op_by_op(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("a CPU solve reached the kernel's wrapper")

    monkeypatch.setattr(tridiag, "block_tridiag", no_kernel)
    A, O, R = map(torch.from_numpy, spd_chain(70, 30, 1, seed=2))
    X = tpg.block_tridiag_solve(A, O, R, q=32)
    assert X.shape == (70, 30, 1)


@pytest.fixture
def traced():
    tracing.reset()
    tracing.enable()
    yield
    tracing.disable()
    tracing.reset()


@pytest.mark.parametrize("solver", ["banded", "direct", "cg"])
def test_lm_iterations_counted(solver, traced):
    """pose_graph.iterations counts the LM's trips, one solve each; CPU
    tensors take no kernel."""
    x0, g = chain_graph(120, 10, seed=3)
    res = tpg.optimize(x0, g, solver=solver, band=10)
    counts = tracing.snapshot()["counts"]
    assert counts["pose_graph.iterations"] == res.iterations >= 2
    assert "pose_graph.solves_on_kernel" not in counts
    assert counts.get("launches.block_tridiag", 0) == 0


@pytest.mark.parametrize("solver", ["banded", "direct"])
def test_kernel_path_on_cpu_runs_the_plain_version(solver, traced,
                                                   monkeypatch):
    """With the rule forced on CPU tensors the LM solves through K6's
    wrapper, which runs the plain version there: one counted solve an
    iteration, and the same LM as op by op in float64 (iterations equal,
    poses within 1e-9)."""
    x0, g = chain_graph(120, 10, seed=4)
    want = tpg.optimize(x0, g, solver=solver, band=10)
    tracing.reset()
    monkeypatch.setattr(tpg, "kernel_path", lambda *a: True)
    got = tpg.optimize(x0, g, solver=solver, band=10)
    counts = tracing.snapshot()["counts"]
    assert counts["pose_graph.solves_on_kernel"] == counts[
        "pose_graph.iterations"] == got.iterations == want.iterations
    assert float((got.poses - want.poses).abs().max()) <= 1e-9
