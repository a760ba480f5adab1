"""Spans and counters of the port's hot paths, off by default.

    from lidar_slam_tpu_torch.utils import tracing
    tracing.reset()
    tracing.enable()
    ...                      # run_slam, online_step, pf_step, ...
    snap = tracing.snapshot()
    tracing.disable()

Off, span(name) returns one shared no-op context and count() returns at
once: either costs a flag test, with no clock read, allocation or torch
call. On, each span records its name, start and end
(time.perf_counter_ns), its id, its parent's id and its root's id, so the
spans of one run_slam, online_step or pf_step call share their root's id;
counters are host integers. While a torch.profiler records, each span also
opens torch.profiler.record_function(name), which puts its interval on
the profiler's clock beside the device's kernels.

Tracing makes no device operation and reads nothing back from the device,
on or off: spans time the host, and every count is a number the host
already holds. The counters:

  icp.sweeps   trips of ops/icp.run_icp_batch's loop (one _icp_body and,
               on CUDA, one nn_argmin launch each; on the fused path also
               one icp_sweep_tail launch);
  host.syncs   reads of a device value back to the host by the port's own
               code on the gtsam path with fixed-interval loops, in
               online_step, in pf_step (which makes none) and in
               models/pose_graph.optimize_sharded: the ICP `done` read,
               the LM `done` read (one a trip of the LM core both
               pose-graph entry points share) and CG residual reads, the
               pose-graph span check, the map build's ray budget and bin
               total, the loss gate when its threshold is finite, and
               run_slam's copies of its results;
  pose_graph.iterations  LM trips of models/pose_graph.optimize and
               optimize_sharded (one linear solve each, in a
               `pose_graph.solve` span);
  pose_graph.solves_on_kernel  block_tridiag_solve calls that K6
               (kernels/tridiag.block_tridiag) served: CUDA tensors, blocks
               at most 32 wide;
  pose_graph.linearizations_on_kernel  LM trips whose factor work K7
               (kernels/factors.py) served: the linearization, and on the
               banded solver the assembly, and the trial cost, one launch
               each; CUDA float32 or float64 poses, so on the card it
               equals pose_graph.iterations;
  filter.chunks  chunks of scans through ops/filters.dbscan_filter_scans
               (main.py --filter_lidar: 310 for 4,956 scans);
  filter.pairs   the pair tests those chunks make, scans x P x P.

The state is the process's, as `logging`'s is: one tracer, driven from
one thread.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import torch

_on = False
_spans: list = []
_counts: dict = {}
_open: list = []  # (id, root) of the spans entered and not yet left
_next_id = 1
_launch_base: dict = {}


class Span(NamedTuple):
    """One recorded span; times in perf_counter nanoseconds, ids from 1,
    parent 0 for a root."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    root: int


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    """A span being timed: recorded when tracing was on at its entry, and
    its seconds stored in `seconds` under the name's last dotted part when
    a dict is given, on or off."""

    __slots__ = ("name", "seconds", "t0", "id", "parent", "root", "rf")

    def __init__(self, name: str, seconds: dict | None):
        self.name, self.seconds = name, seconds
        self.id = 0
        self.rf = None

    def __enter__(self):
        global _next_id
        if _on:
            self.id, _next_id = _next_id, _next_id + 1
            self.parent, self.root = _open[-1] if _open else (0, self.id)
            _open.append((self.id, self.root))
            if torch.autograd._profiler_enabled():
                self.rf = torch.profiler.record_function(self.name)
                self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.seconds is not None:
            self.seconds[self.name.rsplit(".", 1)[-1]] = (t1 - self.t0) * 1e-9
        if self.id:
            if self.rf is not None:
                self.rf.__exit__(*exc)
            if _open and _open[-1][0] == self.id:
                _open.pop()
            _spans.append(Span(self.name, self.t0, t1, self.id, self.parent,
                               self.root))
        return False


def span(name: str, seconds: dict | None = None):
    """A context that records a span called `name` while tracing is on.
    With `seconds`, a dict, the span is timed on or off and its host
    seconds are stored under the name's last dotted part ("slam.odometry"
    -> seconds["odometry"]): run_slam's stage_seconds."""
    if not _on and seconds is None:
        return _NOOP
    return _Span(name, seconds)


def spanned(name: str):
    """Decorator: each call of the function is a span called `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name, None):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while tracing is on."""
    if _on:
        _counts[name] = _counts.get(name, 0) + n


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def _launches() -> dict:
    """The kernel wrappers' own launch counts ("launches.<wrapper>")."""
    from ..kernels import factors, icp, nn, probes, raywalk, tridiag

    return {f"launches.{name}": fn.launches
            for mod in (nn, icp, raywalk, probes, tridiag, factors)
            for name, fn in vars(mod).items()
            if callable(fn) and isinstance(getattr(fn, "launches", None),
                                           int)}


def reset() -> None:
    """Forget every span and counter; the launch counts of the next
    snapshot start from here."""
    global _next_id, _launch_base
    _spans.clear()
    _counts.clear()
    _open.clear()
    _next_id = 1
    _launch_base = _launches()


def snapshot() -> dict:
    """{"spans": [Span, ...] in the order they ended, "counts": {name:
    int}}: the counters, and each kernel wrapper's launches since the last
    reset() as "launches.<wrapper>"."""
    counts = dict(_counts)
    counts.update({k: v - _launch_base.get(k, 0)
                   for k, v in _launches().items()})
    return {"spans": list(_spans), "counts": counts}
