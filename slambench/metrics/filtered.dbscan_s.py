"""Host seconds a log in the program's filter.dbscan spans (the DBSCAN
noise filter over every chunk of scans, ending in a device synchronize
while tracing is on), summed over one log through run_slam with
filter_lidar and tracing on (spans.passes, pass (c)); None where the
program has no such span."""

import spans


def read(run):
    out = spans.passes(run) if run.work.get("runner") == "offline" else None
    if not out or not any(n == "filter.dbscan" for n, _, _ in out["spans"]):
        return None
    return spans.seconds(out, "filter.dbscan")
