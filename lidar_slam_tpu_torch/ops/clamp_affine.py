"""Clamp-affine composition: the occupancy map's per-scan update is an
associative operation over scans.

Counterpart of lidar_slam_tpu/ops/clamp_affine.py. Per cell, one scan's
update is v -> clamp(v + d, -c, +c) (reference modules/ogm.py:188: the
grid is clipped to +/-logodds_clip after every scan), a slope-1
clamp-affine function of v. The family f(v) = clamp(v + a, lo, hi) is
closed under composition:

    (f2 . f1)(v) = clamp(v + (a1 + a2),
                         clamp(lo1 + a2, lo2, hi2),
                         clamp(hi1 + a2, lo2, hi2))

so an N-scan build is an associative product of N per-scan functions,
each held as three grids (a, lo, hi), and the map is F(v0) =
clamp(v0 + a, lo, hi). This is what lets the sharded map builder split
scans across ranks (parallel/sharding.sharded_build_logodds_scans): each
rank composes its contiguous block, and the blocks merge in log2(D)
elementwise composes after one all_gather.

Exactness, as in the JAX package: equal to the sequential build in exact
arithmetic; in float32 bit-equal wherever a cell never touches the rails
and wherever every quantity is exactly representable (integer deltas). A
cell that saturates can differ by a few ULPs of the rail value, one
rounding per binding clip, bounded by the rails. The identity on the
invariant domain [-c, c] is (0, -c, +c).

Plain elementwise torch on any device; nothing is updated in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ClampAffine(NamedTuple):
    """f(v) = clamp(v + a, lo, hi), elementwise over grids."""

    a: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor


def identity(shape, clip: float, dtype=torch.float32,
             device="cpu") -> ClampAffine:
    """The identity function on the invariant domain [-clip, clip]."""
    return ClampAffine(
        a=torch.zeros(shape, dtype=dtype, device=device),
        lo=torch.full(shape, -clip, dtype=dtype, device=device),
        hi=torch.full(shape, clip, dtype=dtype, device=device),
    )


def update(f: ClampAffine, delta: torch.Tensor, clip: float) -> ClampAffine:
    """Compose one per-scan update clamp(. + delta, -clip, clip) after f:
    the special case of compose() for g = (delta, -clip, clip)."""
    return ClampAffine(
        a=f.a + delta,
        lo=torch.clamp(f.lo + delta, -clip, clip),
        hi=torch.clamp(f.hi + delta, -clip, clip),
    )


def compose(f1: ClampAffine, f2: ClampAffine) -> ClampAffine:
    """The function f2 after f1 (f1 applied first). Associative."""
    return ClampAffine(
        a=f1.a + f2.a,
        lo=torch.minimum(torch.maximum(f1.lo + f2.a, f2.lo), f2.hi),
        hi=torch.minimum(torch.maximum(f1.hi + f2.a, f2.lo), f2.hi),
    )


def apply(f: ClampAffine, v0: torch.Tensor) -> torch.Tensor:
    """Evaluate F(v0)."""
    return torch.minimum(torch.maximum(v0 + f.a, f.lo), f.hi)


def compose_tree(fs: list[ClampAffine]) -> ClampAffine:
    """Compose an ordered list (fs[0] applied first) in log2(len) depth."""
    while len(fs) > 1:
        nxt = [compose(fs[i], fs[i + 1]) for i in range(0, len(fs) - 1, 2)]
        if len(fs) % 2:
            nxt.append(fs[-1])
        fs = nxt
    return fs[0]
