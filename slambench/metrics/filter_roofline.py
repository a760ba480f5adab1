"""The scan filters' share of their roofline in a run with filter_lidar:
their work (work_filter.py: 9 FP32 operations a valid pair of a scan, the
points' and masks' bytes) over the device's busy seconds inside the
program's slam.filter spans on the profiler's clock (the spans' length
less the device's idle time inside them; the span ends in a device
synchronize, so its device work lies inside it), pass (d), made by the
filtered runner (runners/offline_filtered.py)."""

import spans
import work
import work_filter


def read(run):
    f = run.work.get("filter") if run.trace is not None else None
    out = run.work.get(spans.KEY) if f else None
    if not out or out.get("filter_busy_s", 0.0) <= 0:
        return None
    return work.roofline_share(
        *work_filter.filter_work(f["pairs"], f["points"]),
        out["filter_busy_s"])
