"""Share of the traced window in which no operation ran on the device:
100 x (1 - busy seconds / window seconds), from the profiler's trace."""

DRIVERS = ("offline",)


def read(run):
    tr = run.trace
    if (tr is None or run.work.get("runner") not in DRIVERS
            or not tr["window_s"]):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
