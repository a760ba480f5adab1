"""The 99th percentile of every step's host milliseconds in the window,
from its (counts, gyro, ranges) row on the host to its pose on the host."""

import numpy as np


def read(run):
    lat = run.work.get("latencies")
    if not lat:
        return None
    return 1e3 * float(np.percentile(np.asarray(lat), 99))
