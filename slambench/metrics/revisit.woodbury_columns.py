"""Right-hand sides of the direct solve an LM iteration: the program's
pose_graph.woodbury_columns counter (1 + 3L a direct solve, L its loop
factors) over its pose_graph.iterations counter, over one log through
run_slam with tracing on (spans.passes, pass (c)); None where the program
has no such counter or made no iteration."""

import spans


def read(run):
    out = spans.passes(run) if run.work.get("runner") == "offline" else None
    if not out:
        return None
    cols = out["counts"].get("pose_graph.woodbury_columns")
    iters = out["counts"].get("pose_graph.iterations")
    return cols / iters if cols is not None and iters else None
