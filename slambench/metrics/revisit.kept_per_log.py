"""Revisit pairs kept a log: the program's revisit.kept counter (the
pairs models/slam.revisit_closures keeps after verification and
suppression) over one log through run_slam with tracing on
(spans.passes, pass (c)); None where the program has no such counter."""

import spans


def read(run):
    out = spans.passes(run) if run.work.get("runner") == "offline" else None
    return None if not out else out["counts"].get("revisit.kept")
