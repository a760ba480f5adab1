"""Mean host seconds of run_slam's "revisit" stage a log (the program's
SlamResult.stage_seconds, the slam.revisit span: the proposer, the
verification ICP and the suppression, ending in the kept pairs' copy to
the host), pass (a) of a traced run; None where no log ran the stage."""


def read(run):
    runs = [s["revisit"] for s in run.work.get("stage_seconds", [])
            if "revisit" in s]
    return sum(runs) / len(runs) if runs else None
