"""Wrappers of the Hopper ray-walk kernels (csrc/raywalk.cu).

raywalk_build (the whole map build) and raywalk_scan (one scan on a carried
grid, in place) launch their kernels for CUDA tensors; for CPU tensors they
run the kernels' plain version, the scatter path
(models/occupancy.build_logodds_scatter and scatter_scan_). There is no
fallback from a CUDA tensor to the plain version: a build or launch
failure raises.

raywalk_build bins every valid ray once into the lists of the square map
regions ("owners", OWNER_SIDE cells a side) that it crosses, each list in
(scan, ray) order (raywalk_bins), and then walks each owner's list in a
warp of its own. raywalk_bins_plain and raywalk_walk_plain are the plain
versions of the two halves, for the tests and chip_smoke.py.
"""

from __future__ import annotations

import torch

from ..config import MapConfig
from ..models.occupancy import (build_logodds_scatter, scan_logodds_cells,
                                scatter_scan_)
from ..utils import tracing
from . import build

OWNER_SIDE = 16  # cells a side of raywalk_build's owners (the kernel's RB_SUB)
BIN_CHUNK = 1024  # rays a warp bins, at the least
TABLE_CAP = 1 << 25  # (owner, chunk) counts, at most about
INT32_MAX = 2**31 - 1
_RAYWALK_BIN = build.Entry("slam_raywalk_bin")  # count, then fill
_RAYWALK_WALK = build.Entry("slam_raywalk_walk")
_RAYWALK_SCAN = build.Entry("slam_raywalk_scan")


def owner_grid(cfg: MapConfig, side: int) -> tuple[int, int]:
    """(owner columns, owner rows): owner (ox, oy) has id ox * rows + oy
    and holds cells [ox side, ox side + side) x [oy side, oy side + side)."""
    return -(-cfg.width // side), -(-cfg.height // side)


def bin_chunk(n_rays: int, n_owners: int) -> int:
    """Rays a warp of the binning kernel takes: BIN_CHUNK, or a larger
    multiple of 32 where the (owner, chunk) count matrix would pass
    TABLE_CAP (a large map)."""
    return max(BIN_CHUNK, -(-n_rays * n_owners // (32 * TABLE_CAP)) * 32)


def _check_rays(ends: torch.Tensor, masks: torch.Tensor, K: int) -> None:
    if (ends.dim() != 3 or ends.shape[-1] != 4
            or ends.dtype is not torch.int32):
        raise ValueError(f"ends must be (N, R, 4) int32, got "
                         f"{tuple(ends.shape)} {ends.dtype}")
    N, R = ends.shape[:2]
    if (masks.shape != (N, R) or masks.dtype is not torch.bool
            or masks.get_device() != ends.get_device()):
        raise ValueError(f"masks must be ({N}, {R}) bool on {ends.device}, "
                         f"got {tuple(masks.shape)} {masks.dtype} "
                         f"{masks.device}")
    if not (ends.is_contiguous() and masks.is_contiguous()):
        raise ValueError("ends and masks must be contiguous")
    if ends.data_ptr() % 16:
        raise ValueError("ends must be 16-byte aligned (rows are read as "
                         "int4)")
    if K <= 0:
        raise ValueError(f"K must be positive, got {K}")
    if N * R > INT32_MAX:
        raise ValueError(f"{N} x {R} rays: ray indices must fit in int32")


def raywalk_bins(ends: torch.Tensor, masks: torch.Tensor, cfg: MapConfig,
                 K: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Every owner's ray list: (bounds (n_owners + 1,) int32, entries
    (total,) int32). Owner o's list is entries[bounds[o]:bounds[o + 1]],
    the global indices s * R + r of the valid rays whose in-map slots
    (K-capped) cross it, in (scan, ray) order.

    For CUDA tensors the binning kernel in two passes (count, then an
    ordered fill), with one host read of the total between them; for CPU
    tensors raywalk_bins_plain.
    """
    if not ends.is_cuda:
        return raywalk_bins_plain(ends, masks, cfg, K)
    _check_rays(ends, masks, K)
    N, R = ends.shape[:2]
    n_rays = N * R
    OW, OH = owner_grid(cfg, OWNER_SIDE)
    n_owners = OW * OH
    bounds = torch.zeros(n_owners + 1, dtype=torch.int32, device=ends.device)
    if n_rays == 0:
        return bounds, bounds[:0]
    chunk = bin_chunk(n_rays, n_owners)
    n_chunks = -(-n_rays // chunk)
    table = torch.zeros((n_owners, n_chunks), dtype=torch.int32,
                        device=ends.device)
    index = ends.get_device()
    args = (ends.data_ptr(), masks.data_ptr(), n_rays, cfg.width, cfg.height,
            int(K), chunk, n_chunks)
    _RAYWALK_BIN(index, *args, table.data_ptr(), None)  # count
    counts = table.view(-1)
    total = int(counts.sum(dtype=torch.int64))  # a build's one host sync
    tracing.count("host.syncs")
    if total > INT32_MAX:
        raise ValueError(f"{total} ray-owner crossings: list positions "
                         f"must fit in int32")
    table = (counts.cumsum(0, dtype=torch.int32) - counts).view(
        n_owners, n_chunks)
    bounds[:-1] = table[:, 0]
    bounds[-1] = total
    entries = torch.empty(total, dtype=torch.int32, device=ends.device)
    _RAYWALK_BIN(index, *args, table.data_ptr(), entries.data_ptr())  # fill
    return bounds, entries


def raywalk_bins_plain(ends: torch.Tensor, masks: torch.Tensor,
                       cfg: MapConfig, K: int, side: int = OWNER_SIDE
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of raywalk_bins: each ray's cells from the scatter
    path's slot layout (scan_logodds_cells), their owners, and the distinct
    (owner, ray) pairs in order."""
    N, R = masks.shape
    OW, OH = owner_grid(cfg, side)
    n_rays = N * R
    rays = torch.arange(R, device=ends.device)[:, None]
    keys = [torch.zeros(0, dtype=torch.int64, device=ends.device)]
    for s in range(N):
        xs, ys, _, valid = scan_logodds_cells(ends[s], masks[s], cfg, K)
        owner = (xs // side).long() * OH + (ys // side).long()
        g = (s * R + rays).expand_as(owner)
        keys.append(torch.unique(owner[valid] * n_rays + g[valid]))
    key = torch.unique(torch.cat(keys))  # sorted: by owner, then ray
    owner, entries = key // max(n_rays, 1), key % max(n_rays, 1)
    counts = torch.bincount(owner, minlength=OW * OH)
    bounds = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    return bounds.to(torch.int32), entries.to(torch.int32)


def raywalk_walk_plain(ends: torch.Tensor, bounds: torch.Tensor,
                       entries: torch.Tensor, cfg: MapConfig, K: int,
                       side: int = OWNER_SIDE,
                       init: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of raywalk_build's walk: each owner's sub-tile
    from its own list alone. The sub-tile takes the adds of its list's rays
    in order and is clipped after the last ray of each scan in the list,
    and once first when the build has scans and the list is empty or starts
    after scan 0."""
    N, R = ends.shape[:2]
    OW, OH = owner_grid(cfg, side)
    clip = cfg.logodds_clip
    grid = (torch.zeros((cfg.width, cfg.height), dtype=torch.float32,
                        device=ends.device)
            if init is None else init.to(torch.float32).clone())
    rays_of = ends.reshape(-1, 4)
    for o in range(OW * OH):
        x0, y0 = o // OH * side, o % OH * side
        tile = grid[x0:x0 + side, y0:y0 + side].clone()
        lst = entries[int(bounds[o]):int(bounds[o + 1])].long()
        scans = lst // max(R, 1)
        if N >= 1 and (lst.numel() == 0 or int(scans[0]) > 0):
            tile.clamp_(-clip, clip)
        for s in torch.unique_consecutive(scans).tolist():
            rays = lst[scans == s]
            xs, ys, vals, valid = scan_logodds_cells(
                rays_of[rays], torch.ones(rays.numel(), dtype=torch.bool,
                                          device=ends.device), cfg, K)
            inside = (valid & (xs >= x0) & (xs < x0 + side) & (ys >= y0)
                      & (ys < y0 + side))
            cells = ((xs[inside] - x0).long() * tile.shape[1]
                     + (ys[inside] - y0).long())
            tile.view(-1).index_add_(0, cells, vals[inside])
            tile.clamp_(-clip, clip)
        grid[x0:x0 + side, y0:y0 + side] = tile
    return grid


def raywalk_build(ends: torch.Tensor, masks: torch.Tensor, cfg: MapConfig,
                  K: int, init: torch.Tensor | None = None) -> torch.Tensor:
    """Log-odds grid (width, height) float32 from ray end cells.

    ends (N, R, 4) int32 rows (sx, sy, ex, ey), masks (N, R) bool, init an
    optional (width, height) starting grid. Scans are applied in order, rays
    in order within a scan, and the grid is clipped after every scan.
    """
    if not ends.is_cuda:
        return build_logodds_scatter(ends, masks, cfg, K, init)
    W, H = cfg.width, cfg.height
    _check_rays(ends, masks, K)
    N, R = ends.shape[:2]
    if init is None:
        grid = torch.zeros((W, H), dtype=torch.float32, device=ends.device)
    else:
        if (init.shape != (W, H) or init.dtype is not torch.float32
                or init.get_device() != ends.get_device()):
            raise ValueError(f"init must be ({W}, {H}) float32 on "
                             f"{ends.device}")
        grid = init.clone()
    bounds, entries = raywalk_bins(ends, masks, cfg, K)
    _RAYWALK_WALK(ends.get_device(), ends.data_ptr(), bounds.data_ptr(),
                  entries.data_ptr(), N, R, W, H, int(K),
                  float(cfg.logodds_ratio), float(cfg.logodds_clip),
                  grid.data_ptr())
    raywalk_build.launches += 1
    return grid


raywalk_build.launches = 0


def raywalk_scan(ends: torch.Tensor, mask: torch.Tensor, cfg: MapConfig,
                 K: int, grid: torch.Tensor,
                 clip: float | None) -> torch.Tensor:
    """Walk one scan's rays into grid (width, height) float32 IN PLACE and
    return grid itself (no copy, no allocation).

    ends (R, 4) int32 rows (sx, sy, ex, ey), mask (R,) bool. Rays are
    applied in order; clip=None leaves the result unclipped (the per-scan
    delta when grid starts at zero), a float clips the whole grid to
    +/-clip afterwards.
    """
    if not ends.is_cuda:
        scatter_scan_(grid, ends, mask, cfg, K)
        if clip is not None:
            grid.clamp_(-clip, clip)
        return grid
    W, H = cfg.width, cfg.height
    if (ends.dim() != 2 or ends.shape[-1] != 4
            or ends.dtype is not torch.int32):
        raise ValueError(f"ends must be (R, 4) int32, got "
                         f"{tuple(ends.shape)} {ends.dtype}")
    R = ends.shape[0]
    index = ends.get_device()
    if (mask.shape != (R,) or mask.dtype is not torch.bool
            or mask.get_device() != index):
        raise ValueError(f"mask must be ({R},) bool on {ends.device}, got "
                         f"{tuple(mask.shape)} {mask.dtype} {mask.device}")
    if (grid.shape != (W, H) or grid.dtype is not torch.float32
            or grid.get_device() != index):
        raise ValueError(f"grid must be ({W}, {H}) float32 on {ends.device}, "
                         f"got {tuple(grid.shape)} {grid.dtype} "
                         f"{grid.device}")
    if not (ends.is_contiguous() and mask.is_contiguous()
            and grid.is_contiguous()):
        raise ValueError("ends, mask and grid must be contiguous")
    if K <= 0:
        raise ValueError(f"K must be positive, got {K}")
    _RAYWALK_SCAN(index, ends.data_ptr(), mask.data_ptr(), R, W, H, int(K),
                  float(cfg.logodds_ratio),
                  0.0 if clip is None else float(clip), int(clip is not None),
                  grid.data_ptr())
    raywalk_scan.launches += 1
    return grid


raywalk_scan.launches = 0
