"""Mean host seconds of run_slam's "scan_matching" stage a log (the program's
SlamResult.stage_seconds; each stage ends in a copy to the host)."""


def read(run):
    runs = [s["scan_matching"] for s in run.work.get("stage_seconds", [])
            if "scan_matching" in s]
    return sum(runs) / len(runs) if runs else None
