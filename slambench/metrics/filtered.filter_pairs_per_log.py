"""Pair tests a log in the program's DBSCAN filter: its filter.pairs
counter (chunk scans x P x P, from the shapes) over one log through
run_slam with filter_lidar and tracing on (spans.passes, pass (c)); None
where the program has no such counter."""

import spans


def read(run):
    out = spans.passes(run) if run.work.get("runner") == "offline" else None
    return None if not out else out["counts"].get("filter.pairs")
