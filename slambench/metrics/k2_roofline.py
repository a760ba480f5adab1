"""K2 (raywalk_scan) share of its roofline over the traced steps of the
online SLAM stream: one launch a scan, each reading its rays and reading
and writing the carried grid once (work.raywalk_work a scan), and one add
a visited cell."""

import trace
import work


def read(run):
    k = run.work.get("k2") if run.trace is not None else None
    if not k:
        return None
    secs, n = trace.kernel_seconds(run.trace, "raywalk_scan_kernel")
    if not n:
        return None
    _, scan_bytes = work.raywalk_work(1, k["rays"], k["width"], k["height"],
                                      0, grid_in=True)
    return work.roofline_share(k["visits"], scan_bytes * k["scans"], secs)
