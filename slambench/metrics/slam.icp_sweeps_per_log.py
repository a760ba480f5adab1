"""ICP sweeps a log: the program's icp.sweeps counter (trips of
ops/icp.run_icp_batch's loop, one nn_argmin launch each on the card) over
one log through run_slam with tracing on (spans.passes, pass (c))."""

import spans


def read(run):
    out = spans.passes(run) if run.work.get("runner") == "offline" else None
    return None if out is None else out["counts"].get("icp.sweeps", 0)
