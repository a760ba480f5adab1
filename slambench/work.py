"""Operations and bytes the kernels' work needs, counted from its shapes,
and a kernel's share of its roofline on the card's published peaks
(peaks.json).

Each count is what the inputs need, whatever the kernel does: for the
nearest-neighbour search (K4) six float32 operations for each pair of a
valid source and a valid target point (a 2-D dot product, the distance and
the comparison) and one read of each input and one write of each output;
for the ray walks (K1, K2) one add a visited cell, and one read of each
input and one write of each output (the grid counted once each way where
the kernel updates it in place).
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())
NN_OPS_PER_PAIR = 6


def nn_work(sweeps: list[dict]) -> tuple[float, float]:
    """(operations, bytes) of nearest-neighbour sweeps (common.NNProbe):
    float32 points of width D, a byte a target's validity, an int32 index
    and a matched point out per source."""
    ops = sum(NN_OPS_PER_PAIR * s["valid_pairs"] for s in sweeps)
    nbytes = sum(s["B"] * (s["N"] * s["D"] * 4 + s["M"] * (s["D"] * 4 + 1)
                           + s["N"] * (4 + s["D"] * 4)) for s in sweeps)
    return float(ops), float(nbytes)


def raywalk_work(n_scans: int, n_rays: int, width: int, height: int,
                 visits: int, grid_in: bool) -> tuple[float, float]:
    """(operations, bytes) of ray walks over n_scans scans of n_rays rays:
    four int32 ray-end cells and a validity byte a ray in, the float32
    grid out (and in, for an update in place), one add a visit."""
    grid = width * height * 4 * (2 if grid_in else 1)
    return float(visits), float(n_scans * n_rays * 17 + grid)


def roofline_share(ops: float, nbytes: float, seconds: float):
    """Percent of the roofline: the least time the card could take (the
    larger of ops over the FP32 peak and bytes over the HBM bandwidth)
    over the measured device seconds; None without a measurement."""
    if not seconds or seconds <= 0:
        return None
    least = max(ops / PEAKS["fp32_flops"], nbytes / PEAKS["hbm_bytes_per_s"])
    return 100.0 * least / seconds
