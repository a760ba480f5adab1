"""Mean host seconds of run_slam's "loop_closures" stage a log (the program's
SlamResult.stage_seconds; each stage ends in a copy to the host)."""


def read(run):
    runs = [s["loop_closures"] for s in run.work.get("stage_seconds", [])
            if "loop_closures" in s]
    return sum(runs) / len(runs) if runs else None
