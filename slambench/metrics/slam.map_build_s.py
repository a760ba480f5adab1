"""Mean host seconds of run_slam's "map_build" stage a log (the program's
SlamResult.stage_seconds; each stage ends in a copy to the host)."""


def read(run):
    runs = [s["map_build"] for s in run.work.get("stage_seconds", [])
            if "map_build" in s]
    return sum(runs) / len(runs) if runs else None
