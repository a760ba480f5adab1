"""Levenberg-Marquardt iterations a log in the pose graph: the program's
pose_graph.iterations counter (trips of models/pose_graph.optimize's loop,
one linear solve each) over one log through run_slam with tracing on
(spans.passes, pass (c)); None where the program has no such counter."""

import spans


def read(run):
    out = spans.passes(run) if run.work.get("runner") == "offline" else None
    return None if not out else out["counts"].get("pose_graph.iterations")
