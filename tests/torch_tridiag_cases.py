"""Seeded block-tridiagonal systems and pose graphs for K6's tests: the
CPU tests (test_torch_tridiag.py) and the card's (test_torch_kernels.py).
Imports no JAX."""

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
