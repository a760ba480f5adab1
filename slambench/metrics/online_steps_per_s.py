"""Steps completed over the whole window's host seconds (session starts
included in the time, not counted as steps)."""


def read(run):
    if "latencies" not in run.work or run.window_s <= 0:
        return None
    return len(run.work["latencies"]) / run.window_s
