"""Wrappers of the Hopper probe kernels P1-P9 (csrc/probes.cu), each with
its plain PyTorch version in this module.

The probes are the port's counterparts of the Pallas kernels in the JAX
package's probe tools (tools/pallas_probe.py P1-P6, scatter_microbench.py
P7-P8, vpu_probe.py P9); lidar_slam_tpu_torch/tools/ times them. Each
wrapper launches its kernel for CUDA tensors and runs its plain version
for CPU tensors. There is no fallback from a CUDA tensor to the plain
version: a build or launch failure raises.

Shared semantics: every probe adds in a fixed order (update, segment or
emit order) into a float32 grid, so kernel and plain version agree bit for
bit. A wrapper's .launches counts one a call, however many CUDA kernels
the call runs. The plain versions add through a 1-D index_add_, which on
the CPU adds in index order whatever the thread count, or loop in order.
Cells outside the grid are dropped.
"""

from __future__ import annotations

import functools

import torch

from . import build

PROBE_SHAPE = (64, 256)  # P1-P4 output (tools/pallas_probe.py W, H)
GRID_SHAPE = (1208, 1216)  # P6-P8: the padded 1201 x 1201 map grid
LOG4 = 1.386  # the log-odds step the probes add (rounded to float32)
TS, LANES = 8, 128  # the TPU tile of P1-P4, P7, P8
VPU_TS = 64  # P9's (64, 128) tile
VPU_MODES = ("rmw", "vec", "full", "fullv", "ray1", "ray2")
RAY_W_MAX = 4096  # ray modes index the word table at i & (ray_w - 1)
ONES_EXACT = 1 << 24  # float32 counts 1.0 + 1.0 + ... exactly up to 2^24

# the C entry points of csrc/probes.cu, one a wrapper
_SMEM_STREAM = build.Entry("slam_probe_smem_stream")
_DYNAMIC_STORE = build.Entry("slam_probe_dynamic_store")
_DYNAMIC_LANE_STORE = build.Entry("slam_probe_dynamic_lane_store")
_MASKED_TILE = build.Entry("slam_probe_masked_tile")
_SCALAR_SUM = build.Entry("slam_probe_scalar_sum")
_FILL = build.Entry("slam_probe_fill")
_TILE_RMW = build.Entry("slam_probe_tile_rmw")
_SEGMENT_RMW = build.Entry("slam_probe_segment_rmw")
_VPU_LOOP = build.Entry("slam_probe_vpu_loop")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, dim: int,
           index: int) -> None:
    """Raise unless t is a contiguous dim-D dtype tensor on CUDA device
    `index` (cheap attributes only: no torch.device object is built)."""
    if t.dtype is not dtype or t.dim() != dim or t.get_device() != index:
        raise ValueError(f"{name} must be a {dim}-D {dtype} tensor on "
                         f"cuda:{index}, got {tuple(t.shape)} {t.dtype} "
                         f"{t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_pairs(xs: torch.Tensor, ys: torch.Tensor) -> int:
    """Check xs and ys as (n,) int32 on xs's device; returns its index."""
    index = xs.get_device()
    _check("xs", xs, torch.int32, 1, index)
    _check("ys", ys, torch.int32, 1, index)
    if xs.shape[0] != ys.shape[0]:
        raise ValueError("xs and ys must have one length")
    return index


def _flat_adds(shape, rows: torch.Tensor, cols: torch.Tensor, vals):
    """(flat, vals) of the adds grid[rows[i], cols[i]] += vals[i], in
    flattened order, cells outside a grid of `shape` dropped; vals may be a
    Python float."""
    W, H = shape
    rows, cols = rows.reshape(-1).long(), cols.reshape(-1).long()
    vals = torch.as_tensor(vals, dtype=torch.float32, device=rows.device)
    vals = vals.expand(rows.shape) if vals.dim() == 0 else vals.reshape(-1)
    ok = (rows >= 0) & (rows < W) & (cols >= 0) & (cols < H)
    return (rows * H + cols)[ok], vals[ok]


def _add_in_order(grid: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                  vals) -> torch.Tensor:
    """grid[rows[i], cols[i]] += vals[i] for i in flattened order, cells
    outside the grid dropped; vals may be a Python float."""
    grid.view(-1).index_add_(0, *_flat_adds(grid.shape, rows, cols, vals))
    return grid


def adds(wrapper, *args):
    """(flat, vals): the flat cell index and value of every add that probe
    `wrapper` (P1-P4, P7, P8) makes into its zero grid on `args`, in
    order. One index_add_ of them into a zero grid of wrapper.shape
    computes the probe (the adds' order aside)."""
    return _flat_adds(wrapper.shape, *wrapper.cells(*args))


def _tile_iota(device, rows: int = TS):
    s = torch.arange(rows, dtype=torch.int32, device=device)[:, None]
    l = torch.arange(LANES, dtype=torch.int32, device=device)[None, :]
    return s.expand(rows, LANES), l.expand(rows, LANES)


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


# -- P1-P4 (tools/pallas_probe.py v1-v4), output PROBE_SHAPE ---------------
#
# P1's tile cells all take the same adds from +0.0, so each holds the
# in-order fold of the entries: the blocks that hold tile cells fold them
# once in a warp, and every block writes its cells once. P2-P4's add one
# value a probe into a zero grid, so a cell's sum depends only on its hit
# count k: each (8, 128) tile position's block counts its hits in integers
# and writes each cell's S_k once. The *_design functions are those
# designs in PyTorch, for the CPU tests.

def smem_stream_cells(xs: torch.Tensor):
    s, l = _tile_iota(xs.device)
    n = xs.shape[0]
    return (s.expand(n, TS, LANES), l.expand(n, TS, LANES),
            xs[:, None, None].expand(n, TS, LANES))


def smem_stream_plain(xs: torch.Tensor) -> torch.Tensor:
    return _add_in_order(_zeros(PROBE_SHAPE, xs.device),
                         *smem_stream_cells(xs))


def smem_stream_design(xs: torch.Tensor) -> torch.Tensor:
    """P1 by its kernel's design: every tile cell takes xs[0], xs[1], ...
    in order from +0.0, so each holds the in-order fold of xs (P5's,
    scalar_sum_plain), and every other cell +0.0. The kernel folds xs once
    in one warp of each block that holds tile cells and writes every cell
    once."""
    out = _zeros(PROBE_SHAPE, xs.device)
    out[:TS, :LANES] = scalar_sum_plain(xs)
    return out


def smem_stream(xs: torch.Tensor) -> torch.Tensor:
    """P1: a zero (64, 256) grid whose static tile [0, 8) x [0, 128) gets
    xs[i] added for every i in order. xs (n,) float32. On the card: a
    float4 a thread over the grid; the blocks holding tile cells fold xs in
    index order in one warp and write the fold to them
    (smem_stream_design; csrc/probes.cu)."""
    if not xs.is_cuda:
        return smem_stream_plain(xs)
    index = xs.get_device()
    _check("xs", xs, torch.float32, 1, index)
    out = torch.empty(PROBE_SHAPE, dtype=torch.float32, device=xs.device)
    _SMEM_STREAM(index, xs.data_ptr(), xs.shape[0], out.data_ptr(),
                 *PROBE_SHAPE)
    smem_stream.launches += 1
    return out


smem_stream.launches = 0
smem_stream.entry = _SMEM_STREAM
smem_stream.plain = smem_stream_plain
smem_stream.cells = smem_stream_cells
smem_stream.shape = PROBE_SHAPE


def dynamic_store_cells(xs: torch.Tensor):
    s, l = _tile_iota(xs.device)
    x8 = (xs // TS * TS)[:, None, None]
    return x8 + s, l.expand(xs.shape[0], TS, LANES), 1.0


def dynamic_store_plain(xs: torch.Tensor) -> torch.Tensor:
    return _add_in_order(_zeros(PROBE_SHAPE, xs.device),
                         *dynamic_store_cells(xs))


def dynamic_store(xs: torch.Tensor) -> torch.Tensor:
    """P2: rows [x8, x8 + 8) x lanes [0, 128) += 1 for every x in order,
    x8 = floor(x / 8) * 8. xs (n,) int32. On the card: a block of 1,024
    threads for each (8, 128) tile position; those at lane tile 0 count
    their row band's hits in integers, and each writes its cells once
    (dynamic_store_design; csrc/probes.cu)."""
    if not xs.is_cuda:
        return dynamic_store_plain(xs)
    index = xs.get_device()
    _check("xs", xs, torch.int32, 1, index)
    out = torch.empty(PROBE_SHAPE, dtype=torch.float32, device=xs.device)
    _DYNAMIC_STORE(index, xs.data_ptr(), xs.shape[0], out.data_ptr(),
                   *PROBE_SHAPE)
    dynamic_store.launches += 1
    return out


dynamic_store.launches = 0
dynamic_store.entry = _DYNAMIC_STORE
dynamic_store.plain = dynamic_store_plain
dynamic_store.cells = dynamic_store_cells
dynamic_store.shape = PROBE_SHAPE


def dynamic_lane_store_cells(xs: torch.Tensor, ys: torch.Tensor):
    s, l = _tile_iota(xs.device)
    x8 = (xs // TS * TS)[:, None, None]
    yl = (ys // LANES * LANES)[:, None, None]
    return x8 + s, yl + l, 1.0


def dynamic_lane_store_plain(xs: torch.Tensor,
                             ys: torch.Tensor) -> torch.Tensor:
    return _add_in_order(_zeros(PROBE_SHAPE, xs.device),
                         *dynamic_lane_store_cells(xs, ys))


def ones_fold(k: torch.Tensor) -> torch.Tensor:
    """S_k, the k-fold in-order float32 sum of 1.0 from +0.0, for integer
    counts k >= 0: float32 holds every integer up to 2^24 and 2^24 + 1.0
    rounds back to 2^24 (to even), so S_k = min(k, 2^24), exactly."""
    return k.clamp(max=ONES_EXACT).to(torch.float32)


def k_fold(k: torch.Tensor, val: float) -> torch.Tensor:
    """S_k, the k-fold in-order float32 sum of val from +0.0, for integer
    counts k >= 0 (the kernels' k_fold_sum): a table of the sums up to the
    largest count, one add at a time."""
    step = torch.tensor(val, dtype=torch.float32)
    sums = [torch.zeros((), dtype=torch.float32)]
    for _ in range(int(k.max()) if k.numel() else 0):
        sums.append(sums[-1] + step)
    return torch.stack(sums).to(k.device)[k]


def _tiles(xs: torch.Tensor, ys: torch.Tensor):
    """(tile, on, TX, TY): each entry's (8, 128) tile position of
    PROBE_SHAPE, row-major over its TX x TY positions, by floor division
    (the kernels' arithmetic shifts), and whether it lies on the grid's
    tiles."""
    W, H = PROBE_SHAPE
    TX, TY = -(-W // TS), -(-H // LANES)
    tx = torch.div(xs.long(), TS, rounding_mode="floor")
    ty = torch.div(ys.long(), LANES, rounding_mode="floor")
    on = (tx >= 0) & (tx < TX) & (ty >= 0) & (ty < TY)
    return tx * TY + ty, on, TX, TY


def _tile_grid(cells: torch.Tensor) -> torch.Tensor:
    """(TX, TS, TY, LANES) tile cells as the PROBE_SHAPE grid, the cells
    past a partial edge tile dropped."""
    W, H = PROBE_SHAPE
    TX, _, TY, _ = cells.shape
    return cells.reshape(TX * TS, TY * LANES)[:W, :H].contiguous()


def dynamic_lane_store_design(xs: torch.Tensor,
                              ys: torch.Tensor) -> torch.Tensor:
    """P3 by its kernel's design: every add is +1.0 to the whole (8, 128)
    tile (floor(x / 8), floor(y / 128)) of a zero grid, so each cell holds
    S_k of its tile's hit count k, whatever the order of the entries. The
    kernel gives each tile position a block, whose threads count its hits
    among all entries in integers (a warp shuffle, then shared memory) and
    write S_k (ones_fold) to its cells once. Entries whose tile lies off
    the grid count for no tile."""
    tile, on, TX, TY = _tiles(xs, ys)
    count = torch.bincount(tile[on], minlength=TX * TY)
    return _tile_grid(ones_fold(count).view(TX, 1, TY, 1).expand(
        TX, TS, TY, LANES))


def dynamic_store_design(xs: torch.Tensor) -> torch.Tensor:
    """P2 by its kernel's design: P3's with every entry on lane tile 0."""
    return dynamic_lane_store_design(xs, torch.zeros_like(xs))


def dynamic_lane_store(xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """P3: as P2 on the tile at lane offset yl = floor(y / 128) * 128.
    xs, ys (n,) int32. On the card: a block of 1,024 threads for each
    (8, 128) tile position of the grid, counting its hits in integers and
    writing each cell once (dynamic_lane_store_design; csrc/probes.cu)."""
    if not xs.is_cuda:
        return dynamic_lane_store_plain(xs, ys)
    index = _check_pairs(xs, ys)
    out = torch.empty(PROBE_SHAPE, dtype=torch.float32, device=xs.device)
    _DYNAMIC_LANE_STORE(index, xs.data_ptr(), ys.data_ptr(), xs.shape[0],
                        out.data_ptr(), *PROBE_SHAPE)
    dynamic_lane_store.launches += 1
    return out


dynamic_lane_store.launches = 0
dynamic_lane_store.entry = _DYNAMIC_LANE_STORE
dynamic_lane_store.plain = dynamic_lane_store_plain
dynamic_lane_store.cells = dynamic_lane_store_cells
dynamic_lane_store.shape = PROBE_SHAPE


def masked_tile_cells(xs: torch.Tensor, ys: torch.Tensor):
    return xs, ys, -LOG4


def masked_tile_plain(xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    return _add_in_order(_zeros(PROBE_SHAPE, xs.device),
                         *masked_tile_cells(xs, ys))


def masked_tile_design(xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """P4 by its kernel's design: every add is -1.386 into one cell of a
    zero grid, so each cell holds S_k (k_fold) of its hit count k, whatever
    the order of the entries. The kernel gives each (8, 128) tile position
    a block, whose threads count the hits of its 1,024 cells with integer
    atomics in shared memory and write each cell's S_k once. Entries whose
    tile lies off the grid count for no cell."""
    tile, on, TX, TY = _tiles(xs, ys)
    cell = (xs.long() % TS) * LANES + ys.long() % LANES
    count = torch.bincount((tile * (TS * LANES) + cell)[on],
                           minlength=TX * TY * TS * LANES)
    return _tile_grid(k_fold(count, -LOG4).view(TX, TY, TS, LANES).permute(
        0, 2, 1, 3))


def masked_tile(xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """P4: cell (x, y) += -1.386 for every (x, y) in order (the TPU did it
    as a masked (8, 128) tile RMW). xs, ys (n,) int32. On the card: a block
    of 1,024 threads for each (8, 128) tile position, counting its cells'
    hits in integers and writing each cell once (masked_tile_design;
    csrc/probes.cu)."""
    if not xs.is_cuda:
        return masked_tile_plain(xs, ys)
    index = _check_pairs(xs, ys)
    out = torch.empty(PROBE_SHAPE, dtype=torch.float32, device=xs.device)
    _MASKED_TILE(index, xs.data_ptr(), ys.data_ptr(), xs.shape[0], -LOG4,
                 out.data_ptr(), *PROBE_SHAPE)
    masked_tile.launches += 1
    return out


masked_tile.launches = 0
masked_tile.entry = _MASKED_TILE
masked_tile.plain = masked_tile_plain
masked_tile.cells = masked_tile_cells
masked_tile.shape = PROBE_SHAPE


# -- P5, P6 (v5_vmem_scalar_read, v6_full_grid_vmem) -----------------------

def scalar_sum_plain(xs: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros((), dtype=torch.float32, device=xs.device)
    for x in xs:
        acc = acc + x
    return acc.reshape(1, 1)


def scalar_sum(xs: torch.Tensor) -> torch.Tensor:
    """P5: the in-order float32 sum of xs (n,) float32, as a (1, 1)
    tensor. On the card: one warp loads 32 entries at a time and folds
    them in index order (csrc/probes.cu)."""
    if not xs.is_cuda:
        return scalar_sum_plain(xs)
    index = xs.get_device()
    _check("xs", xs, torch.float32, 1, index)
    out = torch.empty((1, 1), dtype=torch.float32, device=xs.device)
    _SCALAR_SUM(index, xs.data_ptr(), xs.shape[0], out.data_ptr())
    scalar_sum.launches += 1
    return out


scalar_sum.launches = 0
scalar_sum.entry = _SCALAR_SUM
scalar_sum.plain = scalar_sum_plain


def full_grid_plain(device) -> torch.Tensor:
    return torch.ones(GRID_SHAPE, dtype=torch.float32, device=device)


def full_grid(device) -> torch.Tensor:
    """P6: a (1208, 1216) float32 grid of ones on `device` (on the card:
    16-byte stores, launched on out.device, which names the index that
    an index-less "cuda" leaves to the current device)."""
    device = torch.device(device)
    if device.type != "cuda":
        return full_grid_plain(device)
    out = torch.empty(GRID_SHAPE, dtype=torch.float32, device=device)
    _FILL(out.get_device(), out.data_ptr(), out.numel(), 1.0)
    full_grid.launches += 1
    return out


full_grid.launches = 0
full_grid.entry = _FILL
full_grid.plain = full_grid_plain


# -- P7, P8 (tools/scatter_microbench.py): map-update strategies -----------
#
# P7's kernel partitions the updates stably: by owner tile over chunks of
# TILE_RMW_CHUNK updates (counts, a scan over the chunks, ranks, a fill),
# then inside each owner by cell, and sums each cell's run in order. P8's
# adds are all the same value into a zero grid, so it counts hits per cell
# and turns a count k into the k-fold sum. tile_rmw_design and
# segment_rmw_design are those designs in PyTorch, for the CPU tests.

TILE_RMW_OWNER = (TS, LANES)  # P7's owner tile (the kernel's Own)
TILE_RMW_CHUNK = 8192  # updates a binning block takes


def tile_rmw_cells(xs: torch.Tensor, ys: torch.Tensor, vs: torch.Tensor):
    return xs, ys, vs


def tile_rmw_plain(xs: torch.Tensor, ys: torch.Tensor,
                   vs: torch.Tensor) -> torch.Tensor:
    return _add_in_order(_zeros(GRID_SHAPE, xs.device), xs, ys, vs)


def _stable_rank(keys: torch.Tensor) -> torch.Tensor:
    """For each element, the number of earlier elements with its key."""
    order = torch.argsort(keys, stable=True)
    sorted_keys = keys[order]
    pos = torch.arange(len(keys), device=keys.device)
    new = torch.ones_like(sorted_keys, dtype=torch.bool)
    new[1:] = sorted_keys[1:] != sorted_keys[:-1]
    first = torch.cummax(torch.where(new, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - first
    return rank


def tile_rmw_lists(xs: torch.Tensor, ys: torch.Tensor, vs: torch.Tensor,
                   chunk: int = TILE_RMW_CHUNK):
    """P7's stable partition by owner tile, as its count, scan and fill
    kernels compute it: (bounds (n_owners + 1,), cells, vals). Owner o
    (row-major over the owner grid) holds entries [bounds[o], bounds[o +
    1]): the in-grid updates of its tile in update order, each as its cell
    inside the tile (row-major) and its value."""
    W, H = GRID_SHAPE
    OR, OC = TILE_RMW_OWNER
    OH = -(-H // OC)
    n_owners = -(-W // OR) * OH
    x, y = xs.long(), ys.long()
    ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    i = torch.arange(len(xs), device=xs.device)[ok]
    x, y, v = x[ok], y[ok], vs[ok]
    o = x // OR * OH + y // OC
    c = i // chunk
    n_chunks = -(-len(xs) // chunk)
    counts = torch.bincount(c * n_owners + o, minlength=n_chunks * n_owners)
    counts = counts.view(n_chunks, n_owners)
    prefix = counts.cumsum(0) - counts  # over the chunks, per owner
    totals = counts.sum(0)
    base = totals.cumsum(0) - totals
    pos = base[o] + prefix[c, o] + _stable_rank(c * n_owners + o)
    cells = torch.empty_like(o)
    vals = torch.empty_like(v)
    cells[pos] = x % OR * OC + y % OC
    vals[pos] = v
    bounds = torch.cat([base, totals.sum().reshape(1)])
    return bounds, cells, vals


def tile_rmw_design(xs: torch.Tensor, ys: torch.Tensor,
                    vs: torch.Tensor) -> torch.Tensor:
    """P7 by its kernels' design: the owner lists (tile_rmw_lists), each
    sorted by cell stably, then every cell's run summed in order, one add
    at a time (the kernels sort each window of a list by cell and add the
    windows' runs in list order, which is the same order)."""
    W, H = GRID_SHAPE
    OR, OC = TILE_RMW_OWNER
    bounds, cells, vals = tile_rmw_lists(xs, ys, vs)
    n_owners = len(bounds) - 1
    per_owner = bounds[1:] - bounds[:-1]
    key = torch.repeat_interleave(
        torch.arange(n_owners, device=xs.device), per_owner) * (OR * OC)
    key = key + cells
    count = torch.bincount(key, minlength=n_owners * OR * OC)
    start = count.cumsum(0) - count
    run = torch.empty_like(vals)
    run[start[key] + _stable_rank(key)] = vals
    # the cells by falling count: step j adds the j-th value of every run
    # longer than j, the first live[j] of them
    order = torch.argsort(count, descending=True, stable=True)
    live = len(count) - torch.bincount(count).cumsum(0)
    first = start[order]
    sums = torch.zeros(len(count), dtype=torch.float32, device=xs.device)
    for j, m in enumerate(live[:-1].tolist()):
        sums[:m] = sums[:m] + run[first[:m] + j]
    acc = torch.empty_like(sums)
    acc[order] = sums
    OW = -(-W // OR)
    tiles = acc.view(OW, n_owners // OW, OR, OC).permute(0, 2, 1, 3)
    return tiles.reshape(OW * OR, -1)[:W, :H].contiguous()


def tile_rmw(xs: torch.Tensor, ys: torch.Tensor,
             vs: torch.Tensor) -> torch.Tensor:
    """P7: a zero (1208, 1216) grid with grid[x_i, y_i] += v_i for every update
    i in order (the TPU did one (8, 128) tile RMW per update). xs, ys (u,)
    int32, vs (u,) float32. On the card: five kernels (count, scan, fill,
    sort, sum; see csrc/probes.cu) over (8, 128) owner tiles, scratch from
    torch.empty; tile_rmw.launches counts one a call."""
    if not xs.is_cuda:
        return tile_rmw_plain(xs, ys, vs)
    index = xs.get_device()
    for name, t, dt in (("xs", xs, torch.int32), ("ys", ys, torch.int32),
                        ("vs", vs, torch.float32)):
        _check(name, t, dt, 1, index)
    u = xs.shape[0]
    if not u == ys.shape[0] == vs.shape[0]:
        raise ValueError("xs, ys and vs must have one length")
    out = torch.empty(GRID_SHAPE, dtype=torch.float32, device=xs.device)
    nbytes = _tile_rmw_scratch(u)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=xs.device)
    _TILE_RMW(index, xs.data_ptr(), ys.data_ptr(), vs.data_ptr(), u,
              out.data_ptr(), *GRID_SHAPE, scratch.data_ptr(), nbytes)
    tile_rmw.launches += 1
    return out


@functools.lru_cache(maxsize=64)
def _tile_rmw_scratch(u: int) -> int:
    """Scratch bytes of tile_rmw's kernels for u updates (the C layout)."""
    return build.library().slam_probe_tile_rmw_scratch(u, *GRID_SHAPE)


tile_rmw.launches = 0
tile_rmw.plain = tile_rmw_plain
tile_rmw.cells = tile_rmw_cells
tile_rmw.shape = GRID_SHAPE


def segment_rmw_cells(x8: torch.Tensor, yl: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor):
    l = torch.arange(LANES, dtype=torch.int32, device=x8.device)
    r = (l * a[:, None] + b[:, None]) // 1024  # (n, 128): the row hit
    seg, lane = ((r >= 0) & (r < TS) & (l < 96)).nonzero(as_tuple=True)
    return x8[seg] + r[seg, lane], yl[seg] + lane, -LOG4


def segment_rmw_plain(x8: torch.Tensor, yl: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    return _add_in_order(_zeros(GRID_SHAPE, x8.device),
                         *segment_rmw_cells(x8, yl, a, b))


def segment_rmw_design(x8: torch.Tensor, yl: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """P8 by its kernel's design: each cell's hit count k, then S_k, the
    k-fold in-order float32 sum of -1.386 from +0.0 (every add is the same
    value, so the order of the segments cannot show)."""
    W, H = GRID_SHAPE
    flat, _ = adds(segment_rmw, x8, yl, a, b)
    return k_fold(torch.bincount(flat, minlength=W * H), -LOG4).view(W, H)


def segment_rmw(x8: torch.Tensor, yl: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """P8: a zero (1208, 1216) grid; per segment (x8, yl, a, b), in order, the
    cells (x8 + s, yl + l) of its (8, 128) tile with s == floor((l a + b) /
    1024) and l < 96 get -1.386 (one RMW per segment on the TPU). All (n,)
    int32. On the card: one cooperative kernel that zeroes, counts the
    hits of each cell and turns a count k into the k-fold sum (see
    csrc/probes.cu); segment_rmw.launches counts one a call."""
    if not x8.is_cuda:
        return segment_rmw_plain(x8, yl, a, b)
    index = x8.get_device()
    for name, t in (("x8", x8), ("yl", yl), ("a", a), ("b", b)):
        _check(name, t, torch.int32, 1, index)
    n = x8.shape[0]
    if not n == yl.shape[0] == a.shape[0] == b.shape[0]:
        raise ValueError("x8, yl, a and b must have one length")
    out = torch.empty(GRID_SHAPE, dtype=torch.float32, device=x8.device)
    _SEGMENT_RMW(index, x8.data_ptr(), yl.data_ptr(), a.data_ptr(),
                 b.data_ptr(), n, -LOG4, out.data_ptr(), *GRID_SHAPE)
    segment_rmw.launches += 1
    return out


segment_rmw.launches = 0
segment_rmw.plain = segment_rmw_plain
segment_rmw.cells = segment_rmw_cells
segment_rmw.shape = GRID_SHAPE


# -- P9 (tools/vpu_probe.py): the v8 walk's per-visit work ----------------

def vpu_visits(words: torch.Tensor, n_pairs: int, mode: str, device=None):
    """The visits of one repetition of the P9 loop, in order, as (rt, lt,
    delta): the visit adds the (64, 128) float32 tile delta at rows
    [rt, rt + 64) x lanes [lt, lt + 128); delta is 0.0 where the visit's
    mask is off (the TPU's masked RMW)."""
    dev = words.device if device is None else device
    s, l = _tile_iota(dev, VPU_TS)
    V0 = 3 * s + 5 * l
    ones = torch.ones((VPU_TS, LANES), dtype=torch.float32, device=dev)
    w = words.tolist()
    ray_w = min(n_pairs, RAY_W_MAX)

    def unpack(w2):
        span, d_lo, tile = w2 & 127, (w2 >> 7) & 255, w2 >> 15
        return span, d_lo, (tile & 15) * LANES, (tile >> 4) * VPU_TS

    def emit(C, w2):
        span, d_lo, lt, rt = unpack(w2)
        val = V0 + C
        mk = (val >= 0) & (val < 60000) & (s >= d_lo) & (s - d_lo <= span)
        return rt, lt, torch.where(
            mk, torch.where(s == (C & 63), LOG4, -LOG4), 0.0)

    def ray(i, visits):
        stp = w[4][i] == 1
        dM, dm = max(w[7][i], 1), w[8][i]
        DR, other = (l, s) if stp else (s, l)
        V0r = w[5][i] * dm * DR - w[6][i] * dM * other
        for C, w2 in visits:
            span, d_lo, lt, rt = unpack(w2)
            d_end = w[9][i] - (lt if stp else rt)
            val = V0r + C
            mk = ((val >= 0) & (val < dM) & (DR >= d_lo)
                  & (DR - d_lo <= span))
            yield rt, lt, torch.where(
                mk, torch.where(DR == d_end, LOG4, -LOG4), 0.0)

    for i in range(n_pairs):
        if mode == "rmw":
            yield (i & 7) * VPU_TS, 0, ones
            yield ((i + 3) & 7) * VPU_TS, 0, ones
        elif mode == "vec":
            t1 = (i & 3) | (((i >> 2) & 7) << 4)
            t2 = ((i + 1) & 3) | ((((i >> 2) + 3) & 7) << 4)
            yield emit(i & 1023, 37 | (5 << 7) | (t1 << 15))
            yield emit((i + 7) & 1023, 51 | (9 << 7) | (t2 << 15))
        elif mode in ("full", "fullv"):
            yield emit(w[0][i], w[1][i])
            yield emit(w[2][i], w[3][i])
        else:
            j = i & (ray_w - 1)
            pairs = [(w[0][j], w[1][j])]
            if mode == "ray2":
                pairs.append((w[2][j], w[3][j]))
            yield from ray(j, pairs)


def vpu_adds(words: torch.Tensor, n_pairs: int, mode: str, shape):
    """Per visit of one repetition of the P9 loop, in order: (flat, vals)
    of the cells its mask lets through inside a grid of `shape`, i.e. the
    cells the kernel writes (it skips the TPU's 0.0 adds)."""
    s, l = _tile_iota(words.device, VPU_TS)
    for rt, lt, delta in vpu_visits(words, n_pairs, mode):
        on = delta != 0
        yield _flat_adds(shape, (s + rt)[on], (l + lt)[on], delta[on])


def vpu_loop_plain(words: torch.Tensor, grid: torch.Tensor, n_pairs: int,
                   mode: str, reps: int) -> torch.Tensor:
    """The probe's loop as the TPU ran it: every visit is a masked
    (64, 128) tile RMW (grid[tile] += where(mask, +-1.386, 0.0))."""
    W, H = grid.shape
    for _ in range(reps):
        for rt, lt, delta in vpu_visits(words, n_pairs, mode, grid.device):
            r0, r1 = max(rt, 0), min(rt + VPU_TS, W)
            c0, c1 = max(lt, 0), min(lt + LANES, H)
            if r0 < r1 and c0 < c1:
                grid[r0:r1, c0:c1] += delta[r0 - rt:r1 - rt, c0 - lt:c1 - lt]
    return grid


# P9's kernel: a block owns VPU_OWNER_ROWS x 128 cells of one (64, 128)
# tile position, a cell a thread, keeps them in registers and walks the
# visits that can write them (its list) in order; vpu_owner_lists and
# vpu_loop_design are that design in PyTorch, for the CPU tests.

VPU_OWNER_ROWS = 8  # rows of a P9 owner (the kernel's VO_ROWS)
_U32 = 0xFFFFFFFF


def vpu_visit_words(words: torch.Tensor, n_pairs: int, mode: str):
    """(j, C, w2) of every visit of one repetition of the P9 loop, in
    order, as int64 tensors: the word column (i & (ray_w - 1) in the ray
    modes) and the visit's two words, made from the loop index in rmw
    (the tile row in w2's tile field) and vec (the kernel's vpu_visit)."""
    v = torch.arange(n_pairs * (1 if mode == "ray1" else 2),
                     device=words.device)
    i, h = (v, v * 0) if mode == "ray1" else (v >> 1, v & 1)
    j = i & (min(n_pairs, RAY_W_MAX) - 1) if mode in ("ray1", "ray2") else i
    if mode == "rmw":
        return j, v * 0, ((i + 3 * h) & 7) << 19
    if mode == "vec":
        t = torch.where(h == 1, ((i + 1) & 3) | ((((i >> 2) + 3) & 7) << 4),
                        (i & 3) | (((i >> 2) & 7) << 4))
        return j, (i + 7 * h) & 1023, torch.where(
            h == 1, 51 | (9 << 7), 37 | (5 << 7)) | (t << 15)
    w = words.long()
    return j, w[2 * h, j], w[2 * h + 1, j]


def vpu_owner_lists(words: torch.Tensor, n_pairs: int, mode: str,
                    shape) -> dict:
    """{(tx, ty, k): visit indices} of P9's owners on a grid of `shape`:
    owner k of tile position (tx, ty) holds rows [64 tx + 8 k, + 8) x lanes
    [128 ty, + 128), and exists where its first row lies in the grid. Its
    list is the visits of one repetition, in order, that its kernel's
    filter keeps: those on its tile whose mask band [d_lo, d_lo + span]
    meets its rows (any band in rmw, and a steep ray's, which lies on the
    lanes)."""
    W, H = shape
    j, _, w2 = vpu_visit_words(words, n_pairs, mode)
    tile = w2 >> 15
    span, d_lo = w2 & 127, (w2 >> 7) & 255
    free = torch.full_like(tile, mode == "rmw", dtype=torch.bool)
    if mode in ("ray1", "ray2"):
        free = free | (words.long()[4, j] == 1)
    lists = {}
    for tx in range(-(-W // VPU_TS)):
        for ty in range(-(-H // LANES)):
            on = ((tile >> 4) == tx) & ((tile & 15) == ty)
            for k in range(VPU_TS // VPU_OWNER_ROWS):
                s_lo = k * VPU_OWNER_ROWS
                if tx * VPU_TS + s_lo >= W:
                    break
                band = (d_lo < s_lo + VPU_OWNER_ROWS) & (d_lo + span >= s_lo)
                lists[tx, ty, k] = (on & (free | band)).nonzero().squeeze(1)
    return lists


def _vpu_owner_adds(words, mode, j, C, w2, rt, lt, s, l):
    """(mask, value) of visits (j, C, w2) on the cells (s, l) of their
    owners' tiles at (rt, lt), broadcast to (n, rows, lanes): the kernel's
    vpu_add, unsigned arithmetic as int64 modulo 2**32."""
    j, C, w2, rt, lt = (t[:, None, None] for t in (j, C, w2, rt, lt))
    if mode == "rmw":
        on = torch.ones((len(C), s.shape[1], l.shape[2]), dtype=torch.bool,
                        device=C.device)
        return on, torch.ones((), dtype=torch.float32)
    span, d_lo = w2 & 127, (w2 >> 7) & 255
    if mode in ("ray1", "ray2"):
        w = words.long()
        stp = w[4, j] == 1
        dM = w[7, j].clamp(min=1)
        ca = (w[5, j] * w[8, j]) & _U32
        cb = ((-w[6, j]) & _U32) * dM & _U32
        dr, other = torch.where(stp, l, s), torch.where(stp, s, l)
        on = (((ca * dr + cb * other + C) & _U32) < dM) & (
            ((dr - d_lo) & _U32) <= span)
        end = dr == w[9, j] - torch.where(stp, lt, rt)
    else:
        on = (((3 * s + 5 * l + C) & _U32) < 60000) & (
            ((s - d_lo) & _U32) <= span)
        end = s == (C & 63)
    val = torch.tensor(LOG4, dtype=torch.float32)
    return on, torch.where(end, val, -val)


def vpu_loop_design(words: torch.Tensor, grid: torch.Tensor, n_pairs: int,
                    mode: str, reps: int) -> torch.Tensor:
    """P9 by its kernel's design, in place: each owner (vpu_owner_lists)
    takes its cells once, adds to them, visit by visit of its list and
    repetition by repetition, +-1.386 (+1.0 in rmw) where the visit's mask
    lets a cell through, and writes them once. The owners are independent;
    here they step together, one list entry at a time. (The kernel holds
    up to 4,096 entries of a list in shared memory and walks a longer one a
    part at a time; the order of the adds is the same.)"""
    W, H = grid.shape
    lists = vpu_owner_lists(words, n_pairs, mode, grid.shape)
    if not lists or reps == 0:
        return grid
    dev = grid.device
    tx, ty, k = (torch.tensor(c, device=dev) for c in zip(*lists))
    rt, lt = tx * VPU_TS, ty * LANES
    s = (k * VPU_OWNER_ROWS)[:, None, None] + torch.arange(
        VPU_OWNER_ROWS, device=dev)[None, :, None]
    l = torch.arange(LANES, device=dev)[None, None, :]
    x, y = rt[:, None, None] + s, lt[:, None, None] + l
    mine = (x < W) & (y < H)
    flat = (x * H + y)[mine]
    cells = torch.zeros(mine.shape, dtype=torch.float32, device=dev)
    cells[mine] = grid.view(-1)[flat]
    per = [len(v) for v in lists.values()]
    ids = torch.full((len(per), max(per)), -1, dtype=torch.long, device=dev)
    for o, v in enumerate(lists.values()):
        ids[o, :len(v)] = v
    j, C, w2 = vpu_visit_words(words, n_pairs, mode)
    for _ in range(reps):
        for p in range(ids.shape[1]):
            a = (ids[:, p] >= 0).nonzero().squeeze(1)
            vis = ids[a, p]
            on, add = _vpu_owner_adds(words, mode, j[vis], C[vis], w2[vis],
                                      rt[a], lt[a], s[a], l)
            cells[a] = torch.where(on, cells[a] + add, cells[a])
    grid.view(-1)[flat] = cells[mine]
    return grid


def _vpu_check(words: torch.Tensor, grid: torch.Tensor, n_pairs: int,
               mode: str, reps: int) -> None:
    if mode not in VPU_MODES:
        raise ValueError(f"mode must be one of {VPU_MODES}, got {mode!r}")
    if n_pairs < 0 or reps < 0:
        raise ValueError("n_pairs and reps must be non-negative")
    rows = 10 if mode in ("ray1", "ray2") else 4
    cols = min(n_pairs, RAY_W_MAX) if rows == 10 else n_pairs
    if words.dim() != 2 or words.shape[0] < rows or words.shape[1] < cols:
        raise ValueError(f"words must be at least ({rows}, {cols}) for mode "
                         f"{mode!r}, got {tuple(words.shape)}")


def vpu_loop(words: torch.Tensor, grid: torch.Tensor, n_pairs: int,
             mode: str, reps: int) -> torch.Tensor:
    """P9: reps x n_pairs iterations of the mode's body (vpu_probe.py
    make_kernel) on the carried grid, IN PLACE; returns grid. words (rows,
    cols) int32: 4 rows (C, w2 of two visits) for the pair modes, 10 (plus
    six aux words) for the ray modes; grid (W, H) float32. On the card: one
    kernel, a block for each 8 x 128 owner of a (64, 128) tile position,
    its cells in registers (vpu_loop_design; csrc/probes.cu)."""
    _vpu_check(words, grid, n_pairs, mode, reps)
    if not grid.is_cuda:
        return vpu_loop_plain(words, grid, n_pairs, mode, reps)
    index = grid.get_device()
    _check("grid", grid, torch.float32, 2, index)
    _check("words", words, torch.int32, 2, index)
    _VPU_LOOP(index, words.data_ptr(), words.shape[1], n_pairs,
              VPU_MODES.index(mode), reps, LOG4, grid.data_ptr(), *grid.shape)
    vpu_loop.launches += 1
    return grid


vpu_loop.launches = 0
vpu_loop.plain = vpu_loop_plain

WRAPPERS = (smem_stream, dynamic_store, dynamic_lane_store, masked_tile,
            scalar_sum, full_grid, tile_rmw, segment_rmw, vpu_loop)
