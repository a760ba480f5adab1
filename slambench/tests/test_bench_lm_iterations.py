"""slam.lm_iterations_per_log on hand-made passes: the program's
pose_graph.iterations counter in an offline run, and None where the run
is not offline, where the program has no tracing, or where its tracing
has no such counter."""

import pytest

from bench_paths import harness
import spans  # noqa: E402

COUNTS = {"icp.sweeps": 600, "host.syncs": 640}


def _run(runner, counts):
    out = None if counts is None else {
        "spans": [("slam.run", 1.0, "slam.run")], "counts": counts,
        "idle_s": 0.0, "idle_in": {}}
    return harness.Run(work={"runner": runner, spans.KEY: out}, trace={},
                       state=object())


@pytest.mark.parametrize("runner,counts,want", [
    ("offline", dict(COUNTS, **{"pose_graph.iterations": 50}), 50),
    ("offline", COUNTS, None),
    ("offline", None, None),
    ("stream_slam", dict(COUNTS, **{"pose_graph.iterations": 50}), None),
])
def test_lm_iterations_reads_the_counter(runner, counts, want):
    read = harness.load_module("metrics", "slam.lm_iterations_per_log").read
    assert read(_run(runner, counts)) == want
