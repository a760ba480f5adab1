"""Map correlation: scan-to-map scoring over a grid of pose offsets.

Counterpart of lidar_slam_tpu/ops/correlation.py, the course starter's
mapCorrelation (reference code/pr2_utils.py:12-43): the (n_xs, n_ys, N)
evaluation is one gather-sum, and map_correlation_batch scores a batch of
scans at once.
"""

from __future__ import annotations

from functools import reduce

import torch


def map_correlation(im: torch.Tensor, x_im: torch.Tensor, y_im: torch.Tensor,
                    vp: torch.Tensor, xs: torch.Tensor,
                    ys: torch.Tensor) -> torch.Tensor:
    """Sum of map values at scan endpoints over an offset grid.

    im (nx, ny) map; x_im/y_im physical cell coordinates; vp (..., 2, N)
    world points; xs (n_xs,), ys (n_ys,) offsets. Returns (..., n_xs, n_ys),
    float64 for a float64 map, else float32. Rounding matches the reference:
    half-to-even, then an int cast (code/pr2_utils.py:36-39). Every
    division is by a tensor on the map's device: CUDA multiplies by the
    reciprocal of a Python-scalar divisor, which rounds differently.
    """
    nx, ny = im.shape
    # one computation dtype, as JAX promotes its (non-weak) inputs
    dt = reduce(torch.promote_types,
                (vp.dtype, xs.dtype, ys.dtype, x_im.dtype, y_im.dtype))
    vp, xs, ys, x_im, y_im = (t.to(dt) for t in (vp, xs, ys, x_im, y_im))
    xmin, xmax = x_im[0], x_im[-1]
    ymin, ymax = y_im[0], y_im[-1]
    xres = (xmax - xmin) / torch.full((), nx - 1, dtype=dt, device=im.device)
    yres = (ymax - ymin) / torch.full((), ny - 1, dtype=dt, device=im.device)

    x1 = vp[..., 0, None, :] + xs[:, None]  # (..., n_xs, N)
    y1 = vp[..., 1, None, :] + ys[:, None]  # (..., n_ys, N)
    ix = torch.round((x1 - xmin) / xres).to(torch.int32)
    iy = torch.round((y1 - ymin) / yres).to(torch.int32)

    vx = (ix >= 0) & (ix < nx)
    vy = (iy >= 0) & (iy < ny)
    valid = vx[..., :, None, :] & vy[..., None, :, :]  # (..., n_xs, n_ys, N)

    ixc = ix.clamp(0, nx - 1).long()
    iyc = iy.clamp(0, ny - 1).long()
    vals = im[ixc[..., :, None, :], iyc[..., None, :, :]]
    out_dt = torch.float64 if im.dtype == torch.float64 else torch.float32
    vals = vals.to(out_dt)
    return torch.where(valid, vals, torch.zeros((), dtype=out_dt,
                                                device=vals.device)).sum(-1)


def map_correlation_batch(im, x_im, y_im, vp, xs, ys) -> torch.Tensor:
    """Score a batch of scans/particles: vp (B, 2, N) -> (B, n_xs, n_ys)."""
    if vp.dim() != 3:
        raise ValueError(f"vp must be (B, 2, N), got {tuple(vp.shape)}")
    return map_correlation(im, x_im, y_im, vp, xs, ys)
