"""The reference project's log-odds occupancy map, written plainly.

For each scan in order, at its pose (x, y, yaw):
  - each valid ray starts at the cell of the robot position plus the
    lidar's offset, NOT rotated by the yaw (the reference's quirk), and
    ends at the cell of the scan point rotated by the yaw and moved by the
    robot position; a cell index is ceil((w - world_min) / res) - 1;
  - the ray's cells are Bresenham's (the course starter's bresenham2D);
  - every cell of the ray that lies on the map gets -log 4, except the
    last such cell along the ray, which gets +log 4;
  - after the scan the whole grid is clipped to +/- the clip value.
The map is (width, height), indexed [x cell, y cell].
"""

from __future__ import annotations

import math

import torch

from . import geometry as geo


def cells(world: torch.Tensor, world_min: float, res: float) -> torch.Tensor:
    return (torch.ceil((world - world_min) / res) - 1).long()


def bresenham(sx, sy, ex, ey, kmax: int):
    """Cells of rays (sx, sy) -> (ex, ey) by bresenham2D's recipe, in
    (rays, kmax) slots: the major axis advances one cell a slot; the minor
    axis advances where the sequence (floor(dx/2) - k dy) mod dx does not
    fall from slot k - 1 to slot k. Returns (xs, ys, in_ray)."""
    dx0, dy0 = (ex - sx).abs(), (ey - sy).abs()
    steep = dy0 > dx0
    dx = torch.maximum(dx0, dy0)[:, None]
    dy = torch.minimum(dx0, dy0)[:, None]
    k = torch.arange(kmax, device=sx.device)[None, :]
    m = torch.remainder(torch.div(dx, 2, rounding_mode="floor") - k * dy,
                        torch.clamp(dx, min=1))
    q = torch.cat([torch.zeros_like(m[:, :1]), (m[:, 1:] - m[:, :-1]) >= 0],
                  dim=1).long()
    q = torch.where(dy > 0, q, torch.zeros_like(q))
    minor = torch.cumsum(q, dim=1)
    sgx = torch.where(sx <= ex, 1, -1)[:, None]
    sgy = torch.where(sy <= ey, 1, -1)[:, None]
    st = steep[:, None]
    xs = torch.where(st, sx[:, None] + sgx * minor, sx[:, None] + sgx * k)
    ys = torch.where(st, sy[:, None] + sgy * k, sy[:, None] + sgy * minor)
    return xs, ys, k <= dx


def scan_deltas(poses, points, masks, m: dict, p_rl):
    """Per scan, the sum of its rays' +/- log 4 over the map, (S, W * H),
    in the poses' dtype. poses (S, 3), points (S, R, 2), masks (S, R)."""
    S, R = masks.shape
    W, H = m["width"], m["height"]
    res = m["resolution"]
    T = geo.T_of(poses)
    world = geo.mm(points, T[:, :2, :2].transpose(-1, -2)) + T[:, None, :2, 2]
    ex = cells(world[..., 0], m["world_min_x"], res)
    ey = cells(world[..., 1], m["world_min_y"], res)
    sx = cells(poses[:, 0] + p_rl[0], m["world_min_x"], res)[:, None]
    sy = cells(poses[:, 1] + p_rl[1], m["world_min_y"], res)[:, None]
    sx, sy = sx.expand(S, R), sy.expand(S, R)
    keep = masks.flatten()
    sx, sy, ex, ey = (a.flatten()[keep] for a in (sx, sy, ex, ey))
    scan = torch.arange(S, device=poses.device)[:, None].expand(S, R)
    scan = scan.flatten()[keep]
    out = torch.zeros(S, W * H, dtype=poses.dtype, device=poses.device)
    if scan.numel() == 0:
        return out
    kmax = int(torch.maximum((ex - sx).abs(), (ey - sy).abs()).max()) + 1
    xs, ys, in_ray = bresenham(sx, sy, ex, ey, kmax)
    on = in_ray & (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    k = torch.arange(kmax, device=xs.device)[None, :]
    last = torch.where(on, k, torch.full_like(k, -1)).amax(dim=1,
                                                          keepdim=True)
    L = torch.tensor(math.log(4.0), dtype=poses.dtype, device=poses.device)
    val = torch.where(k == last, L, -L)
    flat = (scan[:, None] * (W * H) + xs * H + ys)[on]
    out.view(-1).index_add_(0, flat, val.expand_as(on)[on])
    return out


def build(poses, points, masks, m: dict, p_rl, grid=None, chunk: int = 16):
    """The map of scans (N, R, 2) with masks (N, R) at poses (N, 3),
    painted in order onto `grid` (W, H) or a zero grid, in poses' dtype."""
    W, H = m["width"], m["height"]
    if grid is None:
        grid = torch.zeros(W * H, dtype=poses.dtype, device=poses.device)
    else:
        grid = grid.reshape(-1).to(poses.dtype).clone()
    clip = m["logodds_clip"]
    for s0 in range(0, poses.shape[0], chunk):
        d = scan_deltas(poses[s0:s0 + chunk], points[s0:s0 + chunk],
                        masks[s0:s0 + chunk], m, p_rl)
        for row in d:
            grid = torch.clamp(grid + row, -clip, clip)
    return grid.reshape(W, H)


def ray_visits(poses, points, masks, m: dict, p_rl) -> int:
    """Cells the valid rays of scans at poses cross, their ends included:
    the sum of max(|dx|, |dy|) + 1 over the rays' cell spans."""
    T = geo.T_of(poses)
    world = geo.mm(points, T[:, :2, :2].transpose(-1, -2)) + T[:, None, :2, 2]
    ex = cells(world[..., 0], m["world_min_x"], m["resolution"])
    ey = cells(world[..., 1], m["world_min_y"], m["resolution"])
    sx = cells(poses[:, 0] + p_rl[0], m["world_min_x"], m["resolution"])
    sy = cells(poses[:, 1] + p_rl[1], m["world_min_y"], m["resolution"])
    span = torch.maximum((ex - sx[:, None]).abs(), (ey - sy[:, None]).abs())
    return int(torch.where(masks, span + 1, torch.zeros_like(span)).sum())
