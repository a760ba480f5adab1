"""Seeded block-tridiagonal systems and pose graphs for K6's and K7's
tests: the CPU tests (test_torch_tridiag.py, test_torch_factors.py) and
the card's (test_torch_kernels.py). Imports no JAX."""

import numpy as np
import torch

from lidar_slam_tpu_torch.config import PoseGraphConfig
from lidar_slam_tpu_torch.models import pose_graph as tpg


def spd_chain(n, b, m, seed):
    """A diagonally dominant SPD block-tridiagonal system (A, O, R),
    float64 numpy, as tests/test_torch_pose_graph.py builds its cases."""
    rng = np.random.default_rng(seed)
    O = rng.normal(0, 0.3, (n - 1, b, b))
    A = np.stack([np.eye(b) * (4.0 + b) + 0.1 * (g + g.T)
                  for g in rng.normal(size=(n, b, b))])
    return A, O, rng.normal(size=(n, b, m))


def chain_graph(n, interval, seed, dtype=torch.float64, device="cpu",
                noise=(0.01, 0.01, 0.005)):
    """(poses0, PoseGraph): an odometry chain of n poses from a seeded
    random drive, each relative pose perturbed by `noise` (x, y in m, yaw
    in rad; poses0 composes them), with an exact live loop from every
    `interval`-th pose to the pose `interval` ahead (the fixed-interval
    loops of the offline cells)."""
    rng = np.random.default_rng(seed)
    gt = np.cumsum(rng.normal([0.05, 0.0, 0.01], [0.01, 0.005, 0.02],
                              (n, 3)), axis=0)
    rel = np.stack([np.linalg.inv(_T(gt[i])) @ _T(gt[i + 1])
                    for i in range(n - 1)])
    rel_noisy = np.stack([r @ _T(rng.normal(0, noise))
                          for r in rel])
    li = np.arange(0, n - interval, interval)
    meas = np.stack([np.linalg.inv(_T(gt[i])) @ _T(gt[i + interval])
                     for i in li])
    poses0 = [gt[0]]
    for r in rel_noisy:
        T = _T(poses0[-1]) @ r
        poses0.append([T[0, 2], T[1, 2], np.arctan2(T[1, 0], T[0, 0])])
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,  # noqa: E731
                                  device=device)
    li_t = torch.as_tensor(li, device=device)
    graph = tpg.make_graph(t(rel_noisy), PoseGraphConfig(), loop_i=li_t,
                           loop_j=li_t + interval, loop_meas=t(meas),
                           loop_mask=torch.ones(len(li), dtype=torch.bool,
                                                device=device))
    return t(poses0), graph


def _T(p):
    c, s = np.cos(p[2]), np.sin(p[2])
    return np.array([[c, -s, p[0]], [s, c, p[1]], [0.0, 0.0, 1.0]])


def interval_graph(n, G, span_mode, seed, dtype=torch.float64, device="cpu",
                   heading=0.0, noise=0.01, init=0.02, keep=0.7):
    """(poses0, PoseGraph): tests/test_pose_graph.py::_interval_graph in
    numpy: a drifting trajectory (its headings turned by `heading`), relative
    measurements perturbed by `noise` in each coordinate, loops of span
    G ("fixed": every G-th pose), 1..G ("mixed": 25 at random), 0..G
    ("mixed_self") or none,
    each live with probability `keep`; poses0 the truth plus `init`
    noise."""
    rng = np.random.default_rng(seed)
    gt = np.cumsum(rng.normal(0, 0.05, (n, 3)), axis=0)
    if heading:  # wrapped to (-pi, pi], as the pipeline's poses are
        gt[:, 2] = np.arctan2(np.sin(gt[:, 2] + heading),
                              np.cos(gt[:, 2] + heading))
    rel = np.stack([np.linalg.inv(_T(gt[i])) @ _T(gt[i + 1]) @ _T(r)
                    for i, r in enumerate(rng.normal(0, noise,
                                                     (n - 1, 3)))])
    if span_mode == "fixed":
        li = np.arange(0, n - G - 1, G)
        lj = li + G
    elif span_mode == "none":
        li = lj = np.zeros((0,), np.int64)
    else:  # "mixed"; "mixed_self" spans 0..G, a span of 0 a self-loop
        li = rng.integers(0, n - G, 25)
        lj = li + rng.integers(int(span_mode == "mixed"), G + 1, 25)
    meas = np.array([np.linalg.inv(_T(gt[i])) @ _T(gt[j])
                     for i, j in zip(li, lj)]).reshape(-1, 3, 3)
    mask = rng.random(len(li)) < keep
    x0 = gt + rng.normal(0, init, (n, 3))
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,  # noqa: E731
                                  device=device)
    graph = tpg.make_graph(t(rel), PoseGraphConfig(),
                           loop_i=torch.as_tensor(li, device=device),
                           loop_j=torch.as_tensor(lj, device=device),
                           loop_meas=t(meas),
                           loop_mask=torch.as_tensor(mask, device=device))
    return t(x0), graph


# K7's graphs: name -> (interval_graph's arguments, robust kernel, band)
FACTOR_CASES = {
    "fixed_97": (dict(n=97, G=10, span_mode="fixed", seed=97), "none", 10),
    "mixed_100": (dict(n=100, G=10, span_mode="mixed", seed=107), "none",
                  10),
    "mixed_64_band_7": (dict(n=64, G=7, span_mode="mixed", seed=455),
                        "none", 7),
    "fixed_205": (dict(n=205, G=10, span_mode="fixed", seed=1445), "none",
                  10),
    "tiny_8": (dict(n=8, G=10, span_mode="none", seed=70), "none", 10),
    # headings around +/-pi: the poses' angles wrap between neighbours
    "heading_pi": (dict(n=120, G=10, span_mode="fixed", seed=5,
                        heading=np.pi), "none", 10),
    # exact measurements at the truth: every |omega| below 1e-6 (_ab's
    # series), most of them 0
    "series": (dict(n=60, G=10, span_mode="fixed", seed=6, noise=0.0,
                    init=0.0), "none", 10),
    # measurements 1e-6 rad from the truth: omega on both sides of 1e-6
    "series_edge": (dict(n=60, G=10, span_mode="mixed", seed=7, noise=1e-6,
                         init=0.0), "none", 10),
    "all_masked": (dict(n=80, G=10, span_mode="fixed", seed=8, keep=0.0),
                   "none", 10),
    "no_loops": (dict(n=80, G=10, span_mode="none", seed=9), "none", 10),
    "huber": (dict(n=90, G=10, span_mode="mixed", seed=10, noise=0.05),
              "huber", 10),
    "cauchy": (dict(n=90, G=10, span_mode="mixed", seed=11, noise=0.05),
               "cauchy", 10),
    "ragged": (dict(n=127, G=10, span_mode="fixed", seed=12), "none", 10),
    # loops from a pose to itself among the others: both cross terms of
    # J^T J land on the pose's diagonal block
    "self_loops": (dict(n=70, G=10, span_mode="mixed_self", seed=14),
                   "none", 10),
    "one_super_block": (dict(n=9, G=4, span_mode="mixed", seed=13), "none",
                        10),
    # the offline cells' shape: 4,956 poses, 495 fixed-interval loops, about
    # 150 of them live
    "cells": (dict(n=4956, G=10, span_mode="fixed", seed=20, keep=0.3),
              "none", 10),
}


def factor_case(name, dtype=torch.float64, device="cpu"):
    """(poses0, PoseGraph, robust kernel, band) of FACTOR_CASES[name]."""
    kw, robust, band = FACTOR_CASES[name]
    x0, graph = interval_graph(dtype=dtype, device=device, **kw)
    return x0, graph, robust, band


def _block_gap(got, want):
    """max |got - want| of each 3 x 3 block (the last two axes) over the
    block's largest entry of |want| (an all-zero block: its gap over
    1e-300, so any gap fails)."""
    if not want.numel():
        return 0.0
    got, want = got.double(), want.double()
    den = torch.clamp(want.abs().amax((-1, -2)), min=1e-300)
    return float(((got - want).abs().amax((-1, -2)) / den).max())


def _scaled_gap(got, want):
    """max |got - want| over max(max |want|, 1)."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1.0)


def k7_gaps(lin, system, cost, lin_ref, system_ref, cost_ref, band):
    """K7's outputs against a reference's, each on its own scale:
    ((J blocks, g), (A_sup, O_sup, R), cost) as kernels/factors returns
    them. The blocks and the 3 x 3 pose blocks of A_sup and O_sup relative
    to their own largest entry; g and R relative to max(max |g|, 1) and
    the cost to max(cost, 1), the LM's own scale
    (pose_graph._levenberg_marquardt): an exact graph's residuals are
    rounding noise around 0."""
    def pose_blocks(M):
        return M.reshape(M.shape[0], band, 3, band, 3).transpose(2, 3)

    (J, g), (A, O, R) = lin, system
    (J_ref, g_ref), (A_ref, O_ref, R_ref) = lin_ref, system_ref
    assert [t.shape for t in J] == [t.shape for t in J_ref]
    assert (A.shape, O.shape, R.shape) == (A_ref.shape, O_ref.shape,
                                           R_ref.shape)
    return {"J": max(_block_gap(a, b) for a, b in zip(J, J_ref)),
            "g": _scaled_gap(g, g_ref),
            "A": _block_gap(pose_blocks(A), pose_blocks(A_ref)),
            "O": _block_gap(pose_blocks(O), pose_blocks(O_ref)),
            "R": _scaled_gap(R, R_ref),
            "cost": abs(float(cost) - float(cost_ref))
            / max(float(cost_ref), 1.0)}
