"""Host seconds a log in the program's revisit.verify spans (the proposed
pairs' verification ICP and its accept and error reads, ending in a
device synchronize while tracing is on) over one log through run_slam
with tracing on (spans.passes, pass (c)); None where the program has no
such span."""

import spans


def read(run):
    out = spans.passes(run) if run.work.get("runner") == "offline" else None
    if not out or not any(n == "revisit.verify" for n, _, _ in out["spans"]):
        return None
    return spans.seconds(out, "revisit.verify")
