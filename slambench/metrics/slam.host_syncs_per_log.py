"""Reads back from the device a log: the program's host.syncs counter (the
ICP and LM done reads, the span check, the map build's reads, run_slam's
copies to the host) over one log through run_slam with tracing on
(spans.passes, pass (c))."""

import spans


def read(run):
    out = spans.passes(run) if run.work.get("runner") == "offline" else None
    return None if out is None else out["counts"].get("host.syncs", 0)
