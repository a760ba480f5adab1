"""Operations and bytes the scan filters' work needs (main.py
--filter_lidar), counted from the log's shapes, whatever implements them:

  DBSCAN     9 FP32 operations for each ordered pair of valid points of a
             scan (itself included): two differences, two squares, a sum,
             the test against eps^2, the neighbour count's add and the
             border test's and/or; a read of each point's two float32
             coordinates and its validity byte, and a write of its kept
             byte;
  statistical  a read of each point's float32 range.
"""

from __future__ import annotations

import numpy as np

OPS_PER_PAIR = 9
BYTES_PER_POINT = 8 + 1 + 1 + 4


def valid_pairs(ranges: np.ndarray, range_min: float,
                range_max: float) -> float:
    """Ordered pairs of valid points summed over the scans of (N, R)
    ranges: sum of n_valid^2 (a ray is valid when range_min <= r <=
    range_max, the program's rule)."""
    r = np.asarray(ranges, np.float32)
    n = ((r >= np.float32(range_min)) & (r <= np.float32(range_max))).sum(1)
    return float((n.astype(np.float64) ** 2).sum())


def filter_work(pairs: float, n_points: int) -> tuple[float, float]:
    """(operations, bytes) of both filters over a log of n_points points
    (scans x rays) with `pairs` ordered valid pairs."""
    return float(OPS_PER_PAIR * pairs), float(BYTES_PER_POINT * n_points)
