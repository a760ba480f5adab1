"""Host seconds a log in the pose graph's linear solves: the program's
pose_graph.solve spans (the banded, direct or CG solve of each LM
iteration), summed over one log through run_slam with tracing on
(spans.passes, pass (c))."""

import spans


def read(run):
    out = spans.passes(run) if run.work.get("runner") == "offline" else None
    return None if out is None else spans.seconds(out, "pose_graph.solve")
