"""The program's own spans and counters (lidar_slam_tpu_torch.utils.tracing)
in a traced run: two passes after the runner's untraced and profiled
passes, made when a metric first asks for them.

  (c) the profiled pass's work again with tracing on and no profiler: the
      spans' host times and the counters;
  (d) the same work again with tracing on under torch.profiler: each
      span's interval on the profiler's clock, so the device's idle time
      is charged to the spans the host was in (idle_in_spans).

The work is the runner's own: one log through run_slam (offline), or the
traced run's trace_steps steps of the stream from a new session. A
program without utils/tracing gets neither pass, and the metrics that read
them read None. Pass (c)'s and (d)'s own figures go to standard error as
one "program trace:" line.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from collections import defaultdict

import common
import harness
import trace

TRACING = "lidar_slam_tpu_torch.utils.tracing"
KEY = "program_trace"


def tracing_module():
    """The program's tracing module, or None where the program has none."""
    try:
        found = importlib.util.find_spec(TRACING) is not None
    except ModuleNotFoundError:
        found = False
    return importlib.import_module(TRACING) if found else None


def idle_intervals(events):
    """(window, idle): the trace.WINDOW span's (start, end) and its thread,
    and the sorted intervals inside it in which no operation ran on the
    device, on the profiler's clock (microseconds). A device event named
    as a host span (a user annotation: a span's mark on the device) is not
    an operation."""
    from torch.autograd import DeviceType

    win = [e for e in events if e.name == trace.WINDOW
           and e.device_type == DeviceType.CPU]
    if not win:
        raise RuntimeError(f"the trace has no {trace.WINDOW} span")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    marks = {e.name for e in events if e.device_type == DeviceType.CPU
             and getattr(e, "is_user_annotation", False)}
    busy = merge(
        (max(e.time_range.start, w0), min(e.time_range.end, w1))
        for e in events if e.device_type == DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
        and e.name not in marks and not e.name.startswith("bench."))
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    return (w0, w1, win[0].thread), idle


def span_intervals(events, names, window) -> dict:
    """{name: the union of the host intervals of the spans called `name`
    on the window's thread, clipped to the window, sorted} for each name
    of `names`."""
    from torch.autograd import DeviceType

    w0, w1, thread = window
    by = defaultdict(list)
    for e in events:
        if (e.name in names and e.device_type == DeviceType.CPU
                and e.thread == thread):
            by[e.name].append((max(e.time_range.start, w0),
                               min(e.time_range.end, w1)))
    return {name: merge(by[name]) for name in names}


def merge(intervals) -> list:
    """Sorted, disjoint union of (start, end) intervals; empty ones dropped."""
    out = []
    for a, b in sorted(iv for iv in intervals if iv[1] > iv[0]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(iv) for iv in out]


def overlap(xs: list, ys: list) -> float:
    """Total length of the intersection of two sorted disjoint interval
    lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_spans(events, names) -> tuple[float, float, dict]:
    """(idle seconds, window seconds, {name: idle seconds inside the union
    of the host spans called `name`}) of a profiled pass's events, for each
    name of `names`: the device's idle intervals intersected with the
    spans'."""
    window, idle = idle_intervals(events)
    by_name = span_intervals(events, set(names), window)
    return (sum(b - a for a, b in idle) * 1e-6,
            (window[1] - window[0]) * 1e-6,
            {name: overlap(idle, ivs) * 1e-6
             for name, ivs in sorted(by_name.items())})


def _work(run):
    """The profiled pass's work, from the runner's own functions."""
    st, kind = run.state, run.work.get("runner")
    runner = harness.load_module("runners", kind, st.env.bench_dir)
    if kind == "offline":
        return lambda: runner.one(st, 0)
    n = st.tr["trace_steps"]
    return lambda: runner.stream(st, None, n)


def _profiled(fn, dev):
    """The profiler's events of fn() inside a trace.WINDOW span, the device
    synchronized before the span ends (as trace.traced)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    common.sync(dev)
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW):
            fn()
            common.sync(dev)
    return prof.events()


def _reduce(snap: dict) -> dict:
    """A snapshot as the metrics read it: each span as (name, seconds, its
    root's name), and the counters."""
    names = {s.id: s.name for s in snap["spans"]}
    return {"spans": [(s.name, (s.end_ns - s.start_ns) * 1e-9,
                       names.get(s.root, s.name)) for s in snap["spans"]],
            "counts": dict(snap["counts"])}


def passes(run) -> dict | None:
    """Passes (c) and (d) of a traced run, made once and kept in
    run.work[KEY]; None without a trace, a runner state or the program's
    tracing module."""
    if KEY in run.work:
        return run.work[KEY]
    tr = tracing_module() if run.trace is not None else None
    if tr is None or run.state is None:
        run.work[KEY] = None
        return None
    fn, dev = _work(run), run.state.dev
    try:
        tr.reset()
        tr.enable()
        common.sync(dev)
        t0 = time.perf_counter()
        fn()
        common.sync(dev)
        host_s = time.perf_counter() - t0
        out = _reduce(tr.snapshot())
        tr.reset()
        events = _profiled(fn, dev)
    finally:
        tr.disable()
        tr.reset()
        getattr(run.state, "loops", []).clear()
    idle_s, window_s, idle_in = idle_in_spans(
        events, {n for n, _, _ in out["spans"]})
    del events
    out |= {"host_s": host_s, "idle_s": idle_s, "window_s": window_s,
            "idle_in": idle_in}
    run.work[KEY] = out
    _report(run, out)
    return out


def roots(out: dict, name: str) -> int:
    """Spans called `name` that are their own root (a step or a log)."""
    return sum(n == name and r == name for n, _, r in out["spans"])


def seconds(out: dict, name: str, root: str | None = None) -> float:
    """Host seconds of the spans called `name`, summed; with `root`, only
    those under a root span called `root`."""
    return sum(s for n, s, r in out["spans"]
               if n == name and (root is None or r == root))


def _report(run, out: dict) -> None:
    """Pass (c)'s and (d)'s figures on standard error, with the untraced
    and profiled passes' beside them for tracing's cost."""
    span_s = defaultdict(float)
    for name, s, _ in out["spans"]:
        span_s[name] += s
    line = {"runner": run.work.get("runner"), "c_host_s": out["host_s"],
            "counts": {k: v for k, v in out["counts"].items() if v},
            "span_s": dict(span_s), "d_idle_s": out["idle_s"],
            "d_window_s": out["window_s"], "d_idle_in_s": out["idle_in"],
            "b_idle_s": run.trace["window_s"] - run.trace["busy_s"],
            "b_window_s": run.trace["window_s"],
            "b_host_window_s": run.trace.get("host_window_s")}
    pre = run.work.get("untraced")
    if pre:
        line["a_steps"], line["a_window_s"] = pre["steps"], pre["window_s"]
    if run.work.get("stage_seconds"):
        line["a_stage_s"] = sum(run.work["stage_seconds"][0].values())
    print("program trace: " + json.dumps(line), file=sys.stderr)
