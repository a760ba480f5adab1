"""Host-side rendering: trajectory plots and map images.

Counterpart of lidar_slam_tpu/utils/plotting.py (reference
modules/utils.py:242-301, modules/ogm.py:66-100, plot_trajectories.py).
Rendering uses matplotlib when importable (the reference's look) and
otherwise a dependency-free rasterizer that draws polylines into a PNG
with the port's Bresenham (ops/bresenham.py, on CPU tensors).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from .png import write_png


def _ensure_dir(fname: str) -> None:
    os.makedirs(os.path.dirname(fname) or ".", exist_ok=True)


_COLORS = [
    (31, 119, 255), (214, 39, 40), (44, 160, 44), (148, 103, 189),
    (255, 127, 14), (140, 86, 75), (227, 119, 194), (127, 127, 127),
    (23, 190, 207), (188, 34, 188),
]


def _have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401

        return True
    except ImportError:
        return False


def plot_trajectories(poses: Sequence[np.ndarray], fname: str,
                      labels: Optional[List[str]] = None,
                      figsize=(10, 10), title: Optional[str] = None) -> None:
    """Overlay multiple (N, 3) trajectories with start/end markers
    (reference: modules/utils.py:242-284)."""
    _ensure_dir(fname)
    if _have_matplotlib():
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=figsize)
        colors = ['blue', 'red', 'green', 'purple', 'orange', 'brown',
                  'pink', 'gray', 'cyan', 'magenta']
        for idx, x_ts in enumerate(poses):
            x, y = x_ts[:, 0], x_ts[:, 1]
            c = colors[idx % len(colors)]
            label = labels[idx] if labels else f"Robot {idx + 1}"
            plt.plot(x, y, label=label, color=c)
            plt.plot(x[0], y[0], marker="s", color=c, label="Start")
            plt.plot(x[-1], y[-1], marker="*", color=c, label="End")
        plt.xlabel("X")
        plt.ylabel("Y")
        plt.title(title or "Robot Trajectory")
        plt.legend()
        plt.savefig(fname)
        plt.close()
        return
    _raster_trajectories(poses, fname)


def _raster_trajectories(poses: Sequence[np.ndarray], fname: str,
                         size: int = 800, margin: float = 0.05) -> None:
    """Fallback: rasterize polylines with the port's Bresenham."""
    from ..ops.bresenham import bresenham_fixed

    allp = np.concatenate([np.asarray(p)[:, :2] for p in poses], axis=0)
    lo = allp.min(axis=0)
    hi = allp.max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    pad = span * margin
    lo, hi = lo - pad, hi + pad
    span = hi - lo

    img = np.full((size, size, 3), 255, np.uint8)
    scale = (size - 1) / span.max()

    for idx, p in enumerate(poses):
        p = np.asarray(p)[:, :2]
        pix = ((p - lo) * scale).astype(np.int32)
        px = np.clip(pix[:, 0], 0, size - 1)
        py = np.clip(size - 1 - pix[:, 1] * 1, 0, size - 1)
        color = _COLORS[idx % len(_COLORS)]
        K = 2 * size
        xs, ys, mask = bresenham_fixed(
            torch.as_tensor(py[:-1]), torch.as_tensor(px[:-1]),
            torch.as_tensor(py[1:]), torch.as_tensor(px[1:]), K)
        xs = xs[mask].numpy()
        ys = ys[mask].numpy()
        ok = (xs >= 0) & (xs < size) & (ys >= 0) & (ys < size)
        img[xs[ok], ys[ok]] = color
    write_png(fname, img)


def view_lidar_points(z_t: np.ndarray, fname: Optional[str] = None) -> None:
    """Scatter one scan's points (reference: modules/utils.py:286-301);
    writes to fname instead of plt.show() when given."""
    if fname:
        _ensure_dir(fname)
    if _have_matplotlib():
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(10, 10))
        plt.scatter(z_t[:, 0], z_t[:, 1], s=1)
        plt.xlabel("X")
        plt.ylabel("Y")
        plt.title("LIDAR Points")
        if fname:
            plt.savefig(fname)
            plt.close()
        else:
            plt.show()
        return
    if fname:
        _raster_trajectories([np.asarray(z_t)], fname)
