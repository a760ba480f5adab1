"""Mean host seconds of run_slam's "pose_graph" stage a log (the program's
SlamResult.stage_seconds; each stage ends in a copy to the host)."""


def read(run):
    runs = [s["pose_graph"] for s in run.work.get("stage_seconds", [])
            if "pose_graph" in s]
    return sum(runs) / len(runs) if runs else None
