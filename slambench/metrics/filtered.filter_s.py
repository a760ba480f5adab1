"""Mean host seconds of run_slam's "filter" stage a log, in a run with
filter_lidar (SlamResult.stage_seconds, the slam.filter span: both scan
filters, ending in a device synchronize), pass (a) of a traced run."""


def read(run):
    runs = [s["filter"] for s in run.work.get("stage_seconds", [])
            if "filter" in s]
    return sum(runs) / len(runs) if runs else None
