"""Reads back from the device a step: the program's host.syncs counter
over the traced steps with tracing on (spans.passes, pass (c)), over the
online.step spans; the runner's own read of the pose is not counted."""

import spans


def read(run):
    out = (spans.passes(run) if run.work.get("runner") == "stream_slam"
           else None)
    if out is None or not spans.roots(out, "online.step"):
        return None
    return out["counts"].get("host.syncs", 0) / spans.roots(out,
                                                            "online.step")
