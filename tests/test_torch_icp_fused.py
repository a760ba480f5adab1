"""The fused ICP sweep (ops/icp.py's fused path: K4 then K5, the carry
updated in place) on the CPU: the rule that chooses it, the contracts of
run_icp_batch's loop that the benchmark's probe and fault planting rely
on, and K5's plain version (kernels/icp.py) held to the op-by-op sweep.
The kernel itself is held to the op-by-op sweep on the card
(tests/test_torch_kernels.py)."""

import itertools

import pytest
import torch

from lidar_slam_tpu_torch.kernels import icp as k5
from lidar_slam_tpu_torch.ops import icp as icp_ops
from lidar_slam_tpu_torch.utils import tracing
from torch_icp_cases import icp_pairs, lockstep, pose_gap

torch.set_num_threads(1)

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.mark.parametrize("device,dtype,planar,metric,trim", list(
    itertools.product([CUDA, CPU], [torch.float32, torch.float64],
                      [True, False], ["point", "point_to_line"],
                      [1.0, 0.55])))
def test_fused_path_rule(device, dtype, planar, metric, trim):
    """Only CUDA float32, planar point-to-point ICP without trimming
    takes K4 and K5; PLICP, TrICP, the 3-D fit, float64 and every CPU
    tensor sweep op by op."""
    want = (device.type == "cuda" and dtype is torch.float32 and planar
            and metric == "point" and trim == 1.0)
    assert icp_ops.fused_path(device, dtype, planar, metric, trim) is want


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """run_icp_batch takes the fused path on CPU tensors (K5's plain
    version)."""
    monkeypatch.setattr(icp_ops, "fused_path", lambda *a: True)


@pytest.fixture
def traced():
    tracing.reset()
    tracing.enable()
    yield
    tracing.disable()
    tracing.reset()


RULES = dict(epsilon=1e-3, max_iters=40, stopping_thresh=1e-4)


@pytest.mark.parametrize("fused", [False, True])
def test_iteration_and_body_called_once_a_sweep(fused, monkeypatch, traced,
                                                request):
    """run_icp_batch calls _icp_body, and _icp_body calls icp_iteration
    with the (B, P, 3) clouds and masks first, through the module, once a
    sweep on either path: the benchmark's NNProbe counts K4's work so."""
    if fused:
        request.getfixturevalue("fused_on_cpu")
    calls = {"body": 0, "iteration": []}
    body, iteration = icp_ops._icp_body, icp_ops.icp_iteration

    def count_body(*a, **k):
        calls["body"] += 1
        return body(*a, **k)

    def count_iteration(src, tgt, src_mask, tgt_mask, *a, **k):
        calls["iteration"].append((tuple(src.shape), src_mask.shape,
                                   "carry" in k))
        return iteration(src, tgt, src_mask, tgt_mask, *a, **k)

    monkeypatch.setattr(icp_ops, "_icp_body", count_body)
    monkeypatch.setattr(icp_ops, "icp_iteration", count_iteration)
    pairs = icp_pairs(5, 120, 150, seed=3)
    res = icp_ops.run_icp_batch(*pairs, **RULES)
    counts = tracing.snapshot()["counts"]
    sweeps = counts["icp.sweeps"]
    assert sweeps == int(res.iters.max()) > 1
    assert counts["host.syncs"] == sweeps
    assert calls["body"] == sweeps
    assert calls["iteration"] == [((5, 120, 3), (5, 120), fused)] * sweeps


@pytest.mark.parametrize("fused", [False, True])
def test_replaced_body_that_sets_done_stops_the_loop(fused, monkeypatch,
                                                     traced, request):
    """The loop stops on the done flags of the carry _icp_body returns,
    also when a replacement returns a new carry (the benchmark plants its
    'state unchanged' fault so)."""
    if fused:
        request.getfixturevalue("fused_on_cpu")
    seen = []

    def body(src, tgt, sm, tm, c, *a, **k):
        seen.append(c.src_t is not None)
        return c._replace(done=torch.ones_like(c.done))

    monkeypatch.setattr(icp_ops, "_icp_body", body)
    pairs = icp_pairs(3, 60, 60, seed=4)
    res = icp_ops.run_icp_batch(*pairs, **RULES)
    assert seen == [fused]
    assert tracing.snapshot()["counts"]["icp.sweeps"] == 1
    assert torch.equal(res.T, pairs[4]) and (res.iters == 0).all()


def test_fused_run_leaves_its_inputs_alone(fused_on_cpu):
    """The fused carry is updated in place; the caller's seeds (a tensor,
    or an expanded identity as the relocalization polish passes) and
    clouds are not."""
    pairs = icp_pairs(4, 80, 90, seed=5)
    kept = [t.clone() for t in pairs]
    seeds = pairs[4].clone()
    seeds[:, 0, 3] = 0.05
    kept_seeds = seeds.clone()
    res = icp_ops.run_icp_batch(*pairs[:4], seeds, **RULES)
    assert torch.equal(seeds, kept_seeds)
    eye = torch.eye(4).expand(4, 4, 4)
    res_eye = icp_ops.run_icp_batch(*pairs[:4], eye, **RULES)
    assert torch.equal(eye, torch.eye(4).expand(4, 4, 4))
    for a, b in zip(pairs, kept):
        assert torch.equal(a, b)
    assert res.T.data_ptr() != seeds.data_ptr()
    assert (res.iters > 1).all() and (res_eye.iters > 1).all()


def test_fused_sweep_refuses_other_icp():
    """icp_iteration's fused sweep (a carry given) is planar
    point-to-point ICP without trimming only."""
    src, tgt, sm, tm, T = icp_pairs(1, 20, 20, seed=6)
    c = icp_ops.initial_icp_carry(T, 20, torch.float32, src)
    for kw in (dict(metric="point_to_line"), dict(planar=False),
               dict(trim_fraction=0.5)):
        with pytest.raises(ValueError, match="fused sweep"):
            icp_ops.icp_iteration(src, tgt, sm, tm, c.T, carry=c,
                                  stop=(1e-3, 10, 1e-4), **kw)


# K5's plain version against the op-by-op sweep, from the same carry each
# sweep. Both see the same K4 answer, so idx and done are equal; T and the
# error differ by float32 rounding of the sums only.
@pytest.mark.parametrize("B,N,M,normalize,invalid,max_iters", [
    (1, 150, 150, False, 0.0, 40),
    (7, 120, 130, True, 0.1, 40),
    (16, 100, 110, False, 0.1, 40),
    (8, 100, 400, True, 0.1, 40),
    (6, 90, 90, False, 0.1, 3),
])
def test_plain_tail_matches_op_sweep_in_lockstep(B, N, M, normalize,
                                                 invalid, max_iters):
    pairs = icp_pairs(B, N, M, seed=B * 100 + N, invalid=invalid)
    eps = 1e-9 if normalize else 1e-3
    sweeps = 0
    for _, op, fused in lockstep(pairs, (eps, max_iters, 1e-4, normalize)):
        sweeps += 1
        assert torch.equal(op.done, fused.done)
        assert torch.equal(op.k, fused.k)
        assert torch.equal(op.idx, fused.idx)
        dt, dr = pose_gap(op.T, fused.T)
        assert float(dt.max()) <= 1e-5 and float(dr.max()) <= 1e-6
        for a, b in ((op.err, fused.err), (op.last_err, fused.last_err)):
            assert torch.allclose(a, b, rtol=1e-5, atol=0)
        live = ~fused.done
        assert torch.allclose(fused.src_t[live],
                              icp_ops._transform(pairs[0], fused.T)[live],
                              rtol=0, atol=1e-5)
    assert bool(op.done.all())
    # the rule reads k before the sweep adds 1
    assert int(op.k.max()) <= max_iters + 1
    if max_iters == 3:
        assert int(op.k.max()) == max_iters + 1
    assert sweeps > 1 and (B == 1 or len(set(op.k.tolist())) > 1)


def test_plain_tail_all_sources_masked():
    """A pair with no valid source fits the identity and measures 0, as
    kabsch_planar and _error do, and stops at once."""
    src, tgt, sm, tm, T = icp_pairs(2, 40, 40, seed=7)
    sm[1] = False
    for normalize in (False, True):
        for _, op, fused in lockstep((src, tgt, sm, tm, T),
                                  (1e-3, 40, 1e-4, normalize), sweeps=1):
            assert bool(fused.done[1]) and float(fused.err[1]) == 0.0
            assert torch.equal(fused.T[1], torch.eye(4))
            assert torch.equal(op.done, fused.done)
            assert torch.equal(op.T[1], fused.T[1])


def test_plain_tail_leaves_done_pairs_frozen():
    """A pair that is done before the sweep keeps every field of its
    carry, its sources under T included."""
    src, tgt, sm, tm, T = icp_pairs(3, 50, 50, seed=8)
    c = icp_ops.initial_icp_carry(T, 50, torch.float32, src)
    c.done[1] = True
    before = [t[1].clone() for t in c]
    idx, matched = icp_ops.nn_argmin(c.src_t, tgt, tm)
    k5.icp_sweep_tail(src, matched, idx, sm, c, False, 1e-3, 40, 1e-4)
    for a, b in zip(before, c):
        assert torch.equal(a, b[1])
    assert (c.k[[0, 2]] == 1).all()
