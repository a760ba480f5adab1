"""Scans of completed logs over the whole window's host seconds, the logs
run back to back through run_slam."""


def read(run):
    if "scans" not in run.work or run.window_s <= 0:
        return None
    return run.work["scans"] / run.window_s
