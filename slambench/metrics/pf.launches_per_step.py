"""Device kernels launched a step over the traced steps (memory copies
and sets not counted), from the profiler's trace."""

DRIVER = "stream_pf"


def read(run):
    if run.trace is None or run.work.get("runner") != DRIVER:
        return None
    return run.trace["launches"] / run.work["steps"]
