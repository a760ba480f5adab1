"""ICP warm-up: multi-seed global alignment of 3-D point clouds.

Counterpart of lidar_slam_tpu/models/warmup.py (the reference's warm-up
harness, code/icp_warm_up/test_icp.py:52-101, utils.py:6-30): align a
canonical model to scanned clouds by sweeping 24 yaw seeds and keeping the
lowest normalized ICP error. The seeds are independent, so each batch of
seeds is one batched non-planar ICP call (ops/icp.run_icp_batch with
planar=False: the 3-D SVD Kabsch fit and the NN kernel at D = 3 on the
card). Everything runs in float32, as the JAX CLI does without x64.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from ..ops import icp as icp_ops
from ..ops.voxel import voxel_downsample
from .slam import resolve_device

# the plain NN holds (B, N, M) float32 distances: JAX's budget for them
NN_BUDGET_BYTES = 1.5e9
NN_CHUNK = 2048  # sources a chunk when one seed's distances exceed it


def read_canonical_model(model_name: str,
                         data_dir: str = "./data") -> np.ndarray:
    """Load the canonical model from .mat, mm -> m
    (reference: code/icp_warm_up/utils.py:6-17)."""
    import scipy.io as sio  # host-side IO only

    model = sio.loadmat(os.path.join(data_dir, model_name, "model.mat"))
    return model["Mdata"].T / 1000.0


def load_pc(model_name: str, idx: int, data_dir: str = "./data") -> np.ndarray:
    """(reference: code/icp_warm_up/utils.py:20-30)"""
    return np.load(os.path.join(data_dir, model_name, f"{idx}.npy"))


def synthetic_model(n_points: int = 5000, seed: int = 0) -> np.ndarray:
    """A 3-D object-like cloud (box shell + surface noise) at the warm-up
    problem's scale, standing in for the unshipped .mat models."""
    r = np.random.default_rng(seed)
    face = r.integers(0, 6, n_points)
    uv = r.uniform(-0.5, 0.5, (n_points, 2))
    pts = np.zeros((n_points, 3))
    axis = face // 2
    sign = np.where(face % 2 == 0, 0.5, -0.5)
    others = [(1, 2), (0, 2), (0, 1)]
    for a in range(3):
        m = axis == a
        pts[m, a] = sign[m]
        pts[m, others[a][0]] = uv[m, 0]
        pts[m, others[a][1]] = uv[m, 1]
    pts *= [0.2, 0.15, 0.3]
    pts += r.normal(0, 0.002, pts.shape)
    return pts


def synthetic_pc(model: np.ndarray, idx: int, seed: int = 0) -> np.ndarray:
    """A rigidly transformed, subsampled, noisy copy of `model`: one
    synthetic target cloud (the ground-truth alignment is the transform
    applied, synthetic_pose)."""
    return _synthetic_pc(model, idx, seed)[0]


def synthetic_pose(model: np.ndarray, idx: int, seed: int = 0) -> np.ndarray:
    """The (4, 4) transform that synthetic_pc(model, idx, seed) applied to
    the model: what best_icp_alignment should recover."""
    return _synthetic_pc(model, idx, seed)[1]


def _synthetic_pc(model: np.ndarray, idx: int, seed: int):
    r = np.random.default_rng(seed + 100 * (idx + 1))
    yaw = r.uniform(-np.pi, np.pi)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    keep = r.random(model.shape[0]) > 0.3
    t = r.uniform(-0.3, 0.3, 3)
    pc = model[keep] @ R.T + t
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return pc + r.normal(0, 0.003, pc.shape), T


def yaw_seed_transforms(source: np.ndarray, target: np.ndarray,
                        n_seeds: int = 24) -> np.ndarray:
    """Yaw-sweep initial transforms with centroid-aligned translation
    (reference: code/icp_warm_up/test_icp.py:70-74)."""
    yaws = np.linspace(0, 2 * np.pi, n_seeds, endpoint=False)
    cs = source.mean(axis=0)
    ct = target.mean(axis=0)
    Ts = np.tile(np.eye(4), (n_seeds, 1, 1))
    for k, yaw in enumerate(yaws):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        Ts[k, :3, :3] = R
        Ts[k, :3, 3] = ct - R @ cs
    return Ts


def seed_batch_rule(n_src: int, n_tgt: int, seed_batch: int):
    """(seeds a batch, NN source chunk or None): the JAX package's memory
    guard on the plain NN's (B, N, M) float32 distances. The batch shrinks
    until it fits NN_BUDGET_BYTES; when one seed alone exceeds it, the
    sources are searched NN_CHUNK at a time (on the CPU; the card's NN
    kernel holds no distance tensor)."""
    bytes_per_seed = 4 * n_src * n_tgt
    batch = max(1, min(seed_batch, int(NN_BUDGET_BYTES
                                       // max(bytes_per_seed, 1))))
    return batch, (NN_CHUNK if bytes_per_seed > NN_BUDGET_BYTES else None)


def best_icp_alignment(
    source: np.ndarray,
    target: np.ndarray,
    n_seeds: int = 24,
    epsilon: float = 0.001,
    voxel_size: float = 0.005,
    downsample_above: int = 20000,
    seed_batch: int = 8,
    device="cuda",
) -> Tuple[np.ndarray, float, np.ndarray, np.ndarray]:
    """Run the yaw sweep as batched 3-D ICP on `device`; return (best_T
    (4, 4), best_error, errors (n_seeds,), iterations (n_seeds,)).

    The reference's flow (test_icp.py:65-94): both clouds voxel-downsampled
    at voxel_size when either exceeds downsample_above points; the
    normalized error; on equal errors the earliest seed wins (np.argmin,
    as the reference's sequential `err < best`). The seeds come from the
    full clouds' centroids, as in the JAX package.
    """
    dev = resolve_device(device)
    src, tgt = np.asarray(source), np.asarray(target)
    if src.shape[0] > downsample_above or tgt.shape[0] > downsample_above:
        src = voxel_downsample(src, voxel_size)
        tgt = voxel_downsample(tgt, voxel_size)
    seeds = yaw_seed_transforms(np.asarray(source), np.asarray(target),
                                n_seeds)

    f32 = dict(dtype=torch.float32, device=dev)
    src_t = torch.as_tensor(np.asarray(src, np.float32), **f32)
    tgt_t = torch.as_tensor(np.asarray(tgt, np.float32), **f32)
    seeds_t = torch.as_tensor(np.asarray(seeds, np.float32), **f32)
    batch, nn_chunk = seed_batch_rule(src.shape[0], tgt.shape[0], seed_batch)

    Ts, errs, iters = [], [], []
    for s in range(0, n_seeds, batch):
        b = min(batch, n_seeds - s)
        res = icp_ops.run_icp_batch(
            src_t.expand(b, -1, -1).contiguous(),
            tgt_t.expand(b, -1, -1).contiguous(),
            torch.ones((b, src.shape[0]), dtype=torch.bool, device=dev),
            torch.ones((b, tgt.shape[0]), dtype=torch.bool, device=dev),
            seeds_t[s:s + b], epsilon=epsilon, normalize_error=True,
            planar=False, nn_chunk=nn_chunk)
        Ts.append(res.T.cpu().numpy())
        errs.append(res.error.cpu().numpy())
        iters.append(res.iters.cpu().numpy())
    Ts, errs = np.concatenate(Ts), np.concatenate(errs)
    best = int(np.argmin(errs))
    return Ts[best], float(errs[best]), errs, np.concatenate(iters)


def visualize_icp_result(source_pc, target_pc, aligned_pc, out_path,
                         voxel: float = 0.0075) -> None:
    """Before/after 3-D scatter (reference: test_icp.py:10-42); no-op
    without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    src = voxel_downsample(np.asarray(source_pc), voxel)
    tgt = voxel_downsample(np.asarray(target_pc), voxel)
    ali = voxel_downsample(np.asarray(aligned_pc), voxel)

    fig = plt.figure(figsize=(10, 5))
    for k, (a, b, title) in enumerate([(src, tgt, "Before Alignment"),
                                       (ali, tgt, "After Alignment")]):
        ax = fig.add_subplot(1, 2, k + 1, projection="3d")
        ax.scatter(a[:, 0], a[:, 1], a[:, 2], c="b", marker=".", label="Source")
        ax.scatter(b[:, 0], b[:, 1], b[:, 2], c="r", marker=".", label="Target")
        ax.view_init(elev=30, azim=30)
        ax.legend()
        ax.set_title(title)
        ax.set_xticks([]); ax.set_yticks([]); ax.set_zticks([])
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    plt.savefig(out_path)
    plt.close()


def view_interactive(clouds, colors=None) -> bool:
    """Open the clouds in an interactive Open3D window when open3d is
    importable (the reference's UI, code/icp_warm_up/utils.py:33-50).
    Returns False, without raising, when open3d or a display is missing,
    so the caller can write export_ply instead."""
    try:
        import open3d as o3d
    except Exception:
        return False
    if isinstance(clouds, np.ndarray):
        clouds = [clouds]
    palette = [(0.0, 0.0, 1.0), (1.0, 0.0, 0.0), (0.0, 0.7, 0.0)]
    geoms = []
    for i, c in enumerate(clouds):
        pcd = o3d.geometry.PointCloud()
        pcd.points = o3d.utility.Vector3dVector(
            np.asarray(c, np.float64).reshape(-1, 3))
        col = (colors[i] if colors is not None
               else palette[i % len(palette)])
        pcd.paint_uniform_color(list(col))
        geoms.append(pcd)
    try:
        o3d.visualization.draw_geometries(geoms)
    except Exception:
        return False  # headless: no display to draw into
    return True


def export_ply(path: str, clouds, colors=None) -> None:
    """Write one or more (N, 3) point clouds into one ASCII PLY file (opens
    in any 3-D viewer: MeshLab, CloudCompare, Open3D, Blender). Each cloud
    gets a default color unless `colors` (list of (r, g, b) uint8 triples)
    is given."""
    if isinstance(clouds, np.ndarray):
        clouds = [clouds]
    palette = [(31, 119, 180), (214, 39, 40), (44, 160, 44),
               (255, 127, 14), (148, 103, 189)]
    if colors is None:
        colors = [palette[i % len(palette)] for i in range(len(clouds))]
    if len(colors) != len(clouds):
        raise ValueError(f"{len(clouds)} clouds but {len(colors)} colors")
    total = sum(int(c.shape[0]) for c in clouds)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {total}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        # one savetxt a cloud: models reach 10^5-10^6 points
        for cloud, (r, g, b) in zip(clouds, colors):
            pts = np.asarray(cloud, np.float64)
            rgb = np.broadcast_to(np.array([r, g, b], np.int64),
                                  (pts.shape[0], 3))
            np.savetxt(f, np.concatenate([pts, rgb], axis=1),
                       fmt="%.6f %.6f %.6f %d %d %d")
