"""Log-odds occupancy grid mapping.

Counterpart of lidar_slam_tpu/models/occupancy.py, with the reference's
semantics (modules/ogm.py:5-231) and quirks:
  - world2grid is ceil((x - min)/res) - 1;
  - the ray ORIGIN is robot xy + the UNROTATED lidar offset p_rl[:2], while
    endpoints use the rotated scan points;
  - along each ray, in-bounds cells get -log4 and the LAST in-bounds cell
    +log4 (a ray leaving the map marks its last in-bounds cell occupied);
  - rays are truncated to K slots tail-first;
  - the grid is clipped to +/-logodds_clip after every scan;
  - finalize: the uint8 grid_map is 1 exactly where sigmoid(-logodds) > 0.5
    (value 1 marks FREE cells).

Two engines build the map from the rays' integer end cells (ray_ends):
the scatter path below (plain PyTorch, the plain version of the kernels)
and the Hopper ray-walk kernels (kernels/raywalk.py, csrc/raywalk.cu):
raywalk_build for a whole build, raywalk_scan for one scan on a carried
grid (update_map, the online mode's step). Both engines apply each cell's
adds in ray order, so their float32 maps are equal bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..config import LidarConfig, MapConfig
from ..ops.bresenham import bresenham_fixed
from ..utils import tracing
from ..utils.precision import in_float64


def world2grid(x: torch.Tensor, y: torch.Tensor,
               cfg: MapConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """World meters -> int32 cell indices: ceil((x - min)/res) - 1,
    computed as ceil((x - min) * (1/res)) - 1 with 1/res rounded to x's
    dtype, as the JAX package computes it: XLA rewrites a division by the
    constant res into that product on every backend, and the two differ
    at cell boundaries (at res = 0.05 on random float32 x). The reciprocal
    is rounded to x's dtype on the host and multiplies as an exact Python
    scalar, so the CPU and CUDA round one product alike and nothing is
    copied to the device."""
    inv = (1.0 / cfg.resolution if x.dtype == torch.float64
           else float(np.float32(1.0) / np.float32(cfg.resolution)))
    i = torch.ceil((x - cfg.world_min_x) * inv).to(torch.int32) - 1
    j = torch.ceil((y - cfg.world_min_y) * inv).to(torch.int32) - 1
    return i, j


def grid2world(i: torch.Tensor, j: torch.Tensor,
               cfg: MapConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cell indices -> world meters, i * res + min (reference
    modules/ogm.py:126-147): the cell's low edge."""
    return (i * cfg.resolution + cfg.world_min_x,
            j * cfg.resolution + cfg.world_min_y)


def max_ray_cells(cfg: MapConfig, range_max: float) -> int:
    """Static bound on cells per ray: ceil(range_max/res) + 8 slack."""
    return int(math.ceil(range_max / cfg.resolution)) + 8


def adaptive_ray_cells(points: torch.Tensor, masks: torch.Tensor,
                       cfg: MapConfig, range_max: float = 30.0) -> int:
    """Slot count from the longest VALID ray in the data (not range_max),
    rounded up to a multiple of 64 and capped by max_ray_cells. Exact: a
    ray's cell count is <= ceil((|p| + |p_rl|)/res) + 1."""
    m = masks.bool()
    tracing.count("host.syncs")
    if not bool(m.any()):
        return 64
    n2 = (points[..., 0] ** 2 + points[..., 1] ** 2)[m].max()
    tracing.count("host.syncs", 2)  # indexing by the mask, then n2
    max_norm = float(np.sqrt(float(n2)))
    k = int(math.ceil((max_norm + 0.28) / cfg.resolution)) + 8
    k64 = int(-(-k // 64) * 64)
    return min(k64, max_ray_cells(cfg, range_max))


def ray_ends(poses: torch.Tensor, points: torch.Tensor,
             cfg: MapConfig) -> torch.Tensor:
    """Integer start and end cells of every ray.

    poses (..., 3), points (..., R, 2) robot-frame scan points (already
    including the lidar offset). Returns (..., R, 4) int32 rows
    (sx, sy, ex, ey): the origin cell (robot xy + unrotated p_rl) and the
    endpoint cell (rotated point + robot xy). The yaw's cos and sin are
    rounded once from float64 (utils/precision.in_float64), so the card's
    cells equal the CPU's."""
    x, y, yaw = poses[..., 0:1], poses[..., 1:2], poses[..., 2:3]
    c, s = in_float64(torch.cos, yaw), in_float64(torch.sin, yaw)
    wx = points[..., 0] * c - points[..., 1] * s + x
    wy = points[..., 0] * s + points[..., 1] * c + y
    p_rl = LidarConfig().p_rl
    sx, sy = world2grid(x + p_rl[0], y + p_rl[1], cfg)
    ex, ey = world2grid(wx, wy, cfg)
    return torch.stack([sx.expand_as(ex), sy.expand_as(ey), ex, ey], dim=-1)


def scan_logodds_cells(ends: torch.Tensor, mask: torch.Tensor,
                       cfg: MapConfig, K: int):
    """Per-scan ray contributions in dense (R, K) slot layout.

    ends (R, 4) int32, mask (R,) bool. Returns (xs, ys, values, valid),
    each (R, K): the slot cells, +/-log4 float32 values, and which slots
    land on the map."""
    sx, sy, ex, ey = ends.unbind(-1)
    xs, ys, in_ray = bresenham_fixed(sx, sy, ex, ey, K)
    in_bounds = (xs >= 0) & (xs < cfg.width) & (ys >= 0) & (ys < cfg.height)
    valid = in_ray & in_bounds & mask[..., None]
    k = torch.arange(K, dtype=torch.int32, device=ends.device)
    last_valid = torch.max(torch.where(valid, k, -1), dim=-1,
                           keepdim=True).values
    L = torch.tensor(cfg.logodds_ratio, dtype=torch.float32,
                     device=ends.device)
    values = torch.where(valid, torch.where(k == last_valid, L, -L),
                         torch.zeros((), dtype=torch.float32,
                                     device=ends.device))
    return xs, ys, values, valid


def scatter_scan_(grid: torch.Tensor, ends: torch.Tensor, mask: torch.Tensor,
                  cfg: MapConfig, K: int) -> torch.Tensor:
    """Add one scan's unclipped contributions to grid (width, height),
    contiguous, in place and return it. ends (R, 4) int32, mask (R,) bool.

    The valid slots are added ray-major with index_add_ on the flattened
    grid: on the CPU a 1-D index_add_ adds in index order whatever the
    thread count, so every cell gets its adds in ray order.
    index_put_(accumulate=True) does not once it runs on several threads.
    On CUDA tensors neither does: the order there is the GPU's own."""
    xs, ys, values, valid = scan_logodds_cells(ends, mask, cfg, K)
    cells = xs[valid].long() * cfg.height + ys[valid].long()
    grid.view(-1).index_add_(0, cells, values[valid])
    return grid


def build_logodds_scatter(ends: torch.Tensor, masks: torch.Tensor,
                          cfg: MapConfig, K: int,
                          init: torch.Tensor | None = None) -> torch.Tensor:
    """The scatter path: the plain version of the ray-walk kernel.

    ends (N, R, 4) int32, masks (N, R) bool. For each scan in order,
    scatter_scan_, then the grid is clipped.
    """
    grid = (torch.zeros((cfg.width, cfg.height), dtype=torch.float32,
                        device=ends.device)
            if init is None else init.to(torch.float32).clone())
    for s in range(ends.shape[0]):
        scatter_scan_(grid, ends[s], masks[s], cfg, K)
        grid.clamp_(-cfg.logodds_clip, cfg.logodds_clip)
    return grid


def update_map(logodds: torch.Tensor, pose: torch.Tensor,
               points: torch.Tensor, mask: torch.Tensor, cfg: MapConfig,
               K: int) -> torch.Tensor:
    """One scan's map update, IN PLACE: add all ray contributions of the
    scan at pose (3,), points (R, 2), mask (R,) to logodds (width, height)
    float32, then clip it (reference modules/ogm.py:149-188). Returns
    logodds itself. The JAX package returns a new grid; updating the
    carried grid in place is the port's counterpart of its donated state.
    raywalk_scan on CUDA tensors, its plain version on CPU tensors."""
    from ..kernels.raywalk import raywalk_scan

    return raywalk_scan(ray_ends(pose, points, cfg), mask, cfg, K, logodds,
                        clip=cfg.logodds_clip)


def build_logodds(
    poses: torch.Tensor,
    points: torch.Tensor,
    masks: torch.Tensor,
    cfg: MapConfig,
    K: int,
    init: torch.Tensor | None = None,
    backend: str = "auto",
) -> torch.Tensor:
    """The full log-odds grid (width, height) float32 from poses (N, 3),
    robot-frame points (N, R, 2) and masks (N, R).

    backend: "auto" runs the ray-walk kernel for CUDA tensors and the
    scatter path for CPU tensors; "cuda" requires CUDA tensors and runs the
    kernel.
    """
    from ..kernels.raywalk import raywalk_build

    check_backend(backend, poses)
    return raywalk_build(ray_ends(poses, points, cfg), masks, cfg, K, init)


def check_backend(backend: str, t: torch.Tensor) -> None:
    """A map builder's backend: "auto" (the kernels for CUDA tensors, their
    plain versions for CPU tensors) or "cuda" (raises for CPU tensors)."""
    if backend not in ("auto", "cuda"):
        raise ValueError(f"unknown map backend {backend!r}; "
                         "known: auto, cuda")
    if backend == "cuda" and not t.is_cuda:
        raise RuntimeError("map backend 'cuda' needs CUDA tensors, got "
                           f"{t.device}")


def finalize_grid(logodds: torch.Tensor) -> torch.Tensor:
    """Threshold log-odds into the uint8 grid_map (1 marks FREE cells)."""
    pmf = 1.0 / (1.0 + torch.exp(logodds))
    return (pmf > 0.5).to(torch.uint8)


def render_logodds(logodds) -> np.ndarray:
    """Min-max normalize + sqrt gamma -> uint8 grayscale image (reference
    rendering semantics: modules/ogm.py:66-85), computed in numpy float64
    on the host."""
    if isinstance(logodds, torch.Tensor):
        logodds = logodds.detach().cpu().numpy()
    lo = np.asarray(logodds, dtype=np.float64)
    den = lo.max() - lo.min()
    norm = (lo - lo.min()) / (den if den > 0 else 1.0)
    return (np.sqrt(norm) * 255.0).astype(np.uint8)


@dataclasses.dataclass
class OccupancyGridMap:
    """Stateful wrapper with the reference class's surface (reference
    modules/ogm.py:5-64) over the functional core above, on `device`:
    update_map paints one scan in place (raywalk_scan on the card),
    build_map a whole log onto the current grid (raywalk_build on the
    card)."""

    cfg: MapConfig
    range_max: float = 30.0
    device: str = "cuda"

    def __post_init__(self):
        from .slam import resolve_device

        self.dev = resolve_device(self.device)
        self.grid_map_width = self.cfg.width
        self.grid_map_height = self.cfg.height
        self.res = self.cfg.resolution
        self.logodds_ratio = self.cfg.logodds_ratio
        self.K = max_ray_cells(self.cfg, self.range_max)
        self.grid_map_log_odds = torch.zeros(
            (self.cfg.width, self.cfg.height), dtype=torch.float32,
            device=self.dev)
        self.grid_map = np.zeros((self.cfg.width, self.cfg.height), np.uint8)

    @classmethod
    def create(cls, resolution, world_map_max_x, world_map_max_y,
               world_map_min_x, world_map_min_y, buffer=1.0, range_max=30.0,
               device="cuda"):
        cfg = MapConfig(resolution=resolution, world_max_x=world_map_max_x,
                        world_max_y=world_map_max_y,
                        world_min_x=world_map_min_x,
                        world_min_y=world_map_min_y, buffer=buffer)
        return cls(cfg=cfg, range_max=range_max, device=device)

    def _f32(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.dev)

    def world2grid(self, x, y) -> np.ndarray:
        i, j = world2grid(self._f32(x), self._f32(y), self.cfg)
        return np.stack([i.cpu().numpy().reshape(-1),
                         j.cpu().numpy().reshape(-1)], axis=-1).squeeze()

    def grid2world(self, i, j) -> np.ndarray:
        x, y = grid2world(torch.as_tensor(np.asarray(i)),
                          torch.as_tensor(np.asarray(j)), self.cfg)
        return np.stack([x.numpy().reshape(-1), y.numpy().reshape(-1)],
                        axis=-1).squeeze()

    def update_map(self, x_t, z_t, mask=None):
        z_t = self._f32(z_t)
        mask = (torch.ones(z_t.shape[0], dtype=torch.bool, device=self.dev)
                if mask is None
                else torch.as_tensor(np.asarray(mask), device=self.dev))
        update_map(self.grid_map_log_odds, self._f32(x_t), z_t[:, :2],
                   mask.contiguous(), self.cfg, self.K)

    def build_map(self, states, meas, masks=None):
        meas = self._f32(meas)
        masks = (torch.ones(meas.shape[:2], dtype=torch.bool, device=self.dev)
                 if masks is None
                 else torch.as_tensor(np.asarray(masks), device=self.dev))
        self.grid_map_log_odds = build_logodds(
            self._f32(states), meas[..., :2], masks.contiguous(), self.cfg,
            self.K, init=self.grid_map_log_odds)
        self.grid_map = finalize_grid(self.grid_map_log_odds).cpu().numpy()

    def plot_log_odds_map(self, fname):
        from ..utils.png import write_png
        write_png(fname, render_logodds(self.grid_map_log_odds))

    def plot_map(self, fname):
        from ..utils.png import write_png
        write_png(fname, (np.asarray(self.grid_map) * 255).astype(np.uint8))
