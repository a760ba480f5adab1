"""Ways to apply per-scan log-odds updates, measured on the card (P7, P8).

Replaces tools/scatter_microbench.py (mb_rmw_kernel :71 via pallas_rmw
:93, mb_seg_kernel :115 via pallas_seg :139). On the TPU the question was
XLA's scatter against a VMEM-resident grid with one (8, 128) tile RMW per
update or per segment. On Hopper it is atomics (index_add_: order-free,
so not bit-exact) against the ordered ownership that the map kernels K1
and K2 use: P7 and P8 give every cell one owner thread, which applies the
cell's adds in update or segment order (kernels/probes.py). The dense
add + clip pass (the per-scan floor) and a sort of (key, payload) pairs
(for bucketing schemes) are timed beside them, at the JAX tool's sizes.

    python -m lidar_slam_tpu_torch.tools.scatter_microbench

Times are CUDA-event means over five calls, each on new inputs, after one
warm-up call (the JAX tool's timeit).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import probes
from . import card, events_ms, require_cuda

REPS = 5  # timed calls a measurement, as in the JAX tool
W, H = probes.GRID_SHAPE  # padded grid (real: 1201 x 1201)
UPDATES = (657_408, 332_800)  # per-scan update counts of the JAX tool
SEGMENTS = (82_432, 41_472)  # about one segment per 8 updates


def make_updates(u: int, seed: int):
    """Plausible ray-shaped updates: lines from a common centre (numpy
    xs, ys int32 and vs float32, as the JAX tool makes them)."""
    rng = np.random.default_rng(seed)
    n_rays = 1081
    k = u // n_rays + 1
    ang = rng.uniform(-2.36, 2.36, n_rays)
    step = np.arange(k)
    xs = (600 + np.cos(ang)[:, None] * step).astype(np.int32)
    ys = (600 + np.sin(ang)[:, None] * step).astype(np.int32)
    xs = xs.reshape(-1)[:u] % W
    ys = ys.reshape(-1)[:u] % H
    vs = np.where(rng.random(u) > 0.01, -1.386, 1.386).astype(np.float32)
    return xs, ys, vs


def seg_args(nseg: int, r: int):
    """The JAX tool's random segments (x8, yl, a, b), int32, for rep r."""
    rng = np.random.default_rng(100 + r)
    x8 = (rng.integers(0, W // 8, nseg) * 8).astype(np.int32)
    yl = (rng.integers(0, H // 128, nseg) * 128).astype(np.int32)
    a = rng.integers(1, 1024, nseg).astype(np.int32)
    b = rng.integers(0, 8192, nseg).astype(np.int32)
    return x8, yl, a, b


def timeit(fn, args: list) -> float:
    """Mean ms of fn(*a) over args[1:], after fn(*args[0])."""
    fn(*args[0])

    def calls():
        for a in args[1:]:
            fn(*a)

    torch.cuda.synchronize()
    return events_ms(calls) / (len(args) - 1)


def index_add(flat: torch.Tensor, vs: torch.Tensor,
              shape=(W, H)) -> torch.Tensor:
    """The library yardstick of P7 (and of the other probes that add into a
    zero grid): a zero grid, then index_add_ of the updates at their flat
    cell indices (atomics on the card)."""
    grid = torch.zeros(shape, dtype=torch.float32, device=vs.device)
    grid.view(-1).index_add_(0, flat, vs)
    return grid


def run(log=print) -> dict:
    dev = torch.device("cuda")
    to_dev = lambda arrays: [torch.as_tensor(a, device=dev)  # noqa: E731
                             for a in arrays]
    res = {"index_add_ms": {}, "tile_rmw_ms": {}, "segment_ms": {},
           "sort_ms": {}}
    for u in UPDATES:
        args = [to_dev(make_updates(u, r)) for r in range(REPS + 1)]
        flat = [probes.adds(probes.tile_rmw, *a) for a in args]
        t = timeit(index_add, flat)
        log(f"torch index_add_   u={u}: {t:7.3f} ms  "
            f"{u / t / 1e3:7.1f}M upd/s")
        res["index_add_ms"][u] = t
        t = timeit(probes.tile_rmw, args)
        log(f"CUDA tile-RMW (P7) u={u}: {t:7.3f} ms  "
            f"{u / t / 1e3:7.1f}M upd/s")
        res["tile_rmw_ms"][u] = t
    for nseg in SEGMENTS:
        args = [to_dev(seg_args(nseg, r)) for r in range(REPS + 1)]
        t = timeit(probes.segment_rmw, args)
        log(f"CUDA segment (P8)  n={nseg}: {t:7.3f} ms  "
            f"{nseg / t / 1e3:7.1f}M seg/s  (~{8 * nseg / t / 1e3:7.1f}M "
            "upd/s)")
        res["segment_ms"][nseg] = t
    for u in UPDATES:
        args = []
        for r in range(REPS + 1):
            xs, ys, vs = to_dev(make_updates(u, 200 + r))
            args.append((xs * H + ys, vs))
        t = timeit(lambda k, v: v[torch.sort(k).indices], args)
        log(f"torch sort         u={u}: {t:7.3f} ms  "
            f"{u / t / 1e3:7.1f}M el/s")
        res["sort_ms"][u] = t
    args = []
    for r in range(REPS + 1):
        rng = np.random.default_rng(300 + r)
        args.append(to_dev([rng.normal(size=(W, H)).astype(np.float32),
                            rng.normal(size=(W, H)).astype(np.float32)]))
    t = timeit(lambda g, d: torch.clamp(g + d, -20.0, 20.0), args)
    log(f"dense add+clip     : {t:7.3f} ms  "
        f"({2 * W * H * 4 / t / 1e6:6.1f} GB/s eff)")
    res["dense_ms"] = t
    return res


def main() -> int:
    require_cuda("scatter_microbench")
    print(card(), flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
