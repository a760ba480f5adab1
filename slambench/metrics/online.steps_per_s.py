"""Steps over the host seconds of the untraced stream that a traced run
makes before its profiled steps (trace_steps of them, closed loop, the
session's start inside the time). The stream SLAM cell's rate, read per
layer: over whole windows it spreads too widely for a bound (PERF.md)."""

DRIVER = "stream_slam"


def read(run):
    pre = run.work.get("untraced")
    if run.work.get("runner") != DRIVER or not pre or pre["window_s"] <= 0:
        return None
    return pre["steps"] / pre["window_s"]
