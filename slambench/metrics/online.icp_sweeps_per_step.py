"""ICP sweeps a step: the program's icp.sweeps counter over the traced
steps with tracing on (spans.passes, pass (c)), over the online.step
spans."""

import spans


def read(run):
    out = (spans.passes(run) if run.work.get("runner") == "stream_slam"
           else None)
    if out is None or not spans.roots(out, "online.step"):
        return None
    return out["counts"].get("icp.sweeps", 0) / spans.roots(out,
                                                            "online.step")
