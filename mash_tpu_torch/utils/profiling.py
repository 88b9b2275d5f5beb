"""Tracing, host spans and counters.

Every CLI invocation can capture a PyTorch profiler trace and a
per-stage report:

- ``MASH_TPU_TORCH_TRACE=<dir>``: write a Chrome trace of the whole
  command (host ops and, on a GPU, CUDA kernels) to
  ``<dir>/trace.json`` (view in ``chrome://tracing`` or Perfetto).
- ``MASH_TPU_TORCH_TIMINGS=1``: record the stages and counters below and
  print them to stderr at command exit: each stage's wall time, its self
  time (the wall time less what its child stages cover), its calls, and
  each counter's total.

Library code marks stages with :func:`stage` and counts with
:func:`count`.  With timings off, ``stage`` hands back one shared no-op
context and ``count`` returns at once.  With timings on, each stage adds
to its name's totals and keeps a record: its name, its parent (the stage
open around it on the same thread), and its start and end on
``time.time_ns``, the clock of ``torch.profiler``'s events, so that a
record lines up with a trace's kernels and idle gaps.  Each count keeps
its time too.  Records stay in memory until :func:`pop_records`.

Device work is asynchronous, so a stage's wall time covers what it
enqueued and whatever it waited for, not its device time.  The stages
named ``wait:*`` are the places where the host blocks on the card:

- ``wait:upload_slot``: ``utils.transfer.Uploader`` waits for the copy
  that last used a pinned slot;
- ``wait:readback``: ``utils.transfer.Readback`` waits for its copy
  (the certificate masks);
- ``wait:to_host``: ``utils.transfer.to_host``, a blocking read-back
  (a finished sketch, the screen's counts).

Two stages hold such waits: ``transfer:upload`` (``Uploader.upload``:
the slot's wait, the copy into it where the route stages, and the start
of the copy to the card) and ``engine:settle``
(``ops.sketch_ops.fold_batch``: the previous batch's rows without the
certificate merged in, after its mask's wait).

The counters ``sketch:rows_folded`` (rows of per-row states folded into
a sketch state) and ``sketch:rows_recomputed`` (rows without the
certificate, recomputed on the plain path) count the certificate's
misses.  The counters ``transfer:direct_bytes`` (bytes
``Uploader.upload`` sent straight from the caller's pinned memory) and
``transfer:staged_bytes`` (bytes it copied into a pinned slot first)
say how often each upload route ran.
"""

from __future__ import annotations

import atexit
import contextlib
import itertools
import os
import sys
import threading
import time
from collections import defaultdict
from typing import NamedTuple

_TIMINGS_ENABLED = bool(os.environ.get("MASH_TPU_TORCH_TIMINGS"))
# name -> [seconds, calls, self seconds]
_ACC: dict = defaultdict(lambda: [0.0, 0, 0.0])
# (serial, name, parent serial or -1, start_ns, end_ns) of each finished
# stage, in the order they ended
_RECORDS: list = []
_COUNTS: list = []  # (name, n, at_ns)
_LOCAL = threading.local()  # each thread's stack of open stages
_SERIAL = itertools.count()
_NULL = contextlib.nullcontext()
_REPORT_REGISTERED = False


class Span(NamedTuple):
    """One finished stage: ``parent`` is the index of the enclosing
    stage's record in the same :func:`pop_records` list, -1 where there
    was none (or it was popped before)."""

    name: str
    parent: int
    start_ns: int
    end_ns: int


class Count(NamedTuple):
    name: str
    n: int
    at_ns: int


class _Span:
    __slots__ = ("name", "serial", "parent", "start", "child_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        try:
            stack = _LOCAL.stack
        except AttributeError:
            stack = _LOCAL.stack = []
        self.parent = stack[-1].serial if stack else -1
        self.serial = next(_SERIAL)
        self.child_ns = 0
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        stack = _LOCAL.stack
        stack.pop()
        took = end - self.start
        if stack:
            stack[-1].child_ns += took
        cell = _ACC[self.name]
        cell[0] += took * 1e-9
        cell[1] += 1
        cell[2] += (took - self.child_ns) * 1e-9
        # a tuple of atomic values, which the garbage collector stops
        # tracking
        _RECORDS.append((self.serial, self.name, self.parent, self.start,
                         end))
        return False


def _register_report():
    global _REPORT_REGISTERED
    if not _REPORT_REGISTERED:
        _REPORT_REGISTERED = True
        atexit.register(stage_report)


def stage(name: str):
    """A context that times the named stage (a shared no-op when timings
    are off)."""
    if not _TIMINGS_ENABLED:
        return _NULL
    if not _REPORT_REGISTERED:
        _register_report()
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the named counter (nothing when timings are off)."""
    if not _TIMINGS_ENABLED:
        return
    if not _REPORT_REGISTERED:
        _register_report()
    _COUNTS.append((name, n, time.time_ns()))


def counter_totals(counts) -> dict:
    """``{counter: total}`` of ``(name, n, at_ns)`` records."""
    out: dict = {}
    for name, n, _at in counts:
        out[name] = out.get(name, 0) + n
    return out


def stage_report(out=None):
    """Print the stages' totals, self times and calls, and the counters
    not yet popped (stderr by default)."""
    out = out or sys.stderr
    totals = counter_totals(_COUNTS)
    if not _ACC and not totals:
        return
    width = max(len(k) for k in list(_ACC) + list(totals))
    out.write("-- mash-tpu-torch stage timings --\n")
    for name, (total, calls, own) in sorted(
        _ACC.items(), key=lambda kv: -kv[1][0]
    ):
        out.write(
            "%-*s  %9.3f s  self %9.3f s  (%d call%s)\n"
            % (width, name, total, own, calls, "s" if calls != 1 else "")
        )
    for name, n in sorted(totals.items()):
        out.write("%-*s  %d\n" % (width, name, n))


def pop_stage_totals() -> dict:
    """``{stage: seconds}`` accumulated so far; starts the next count
    from zero (a caller timing several commands reads one at a time)."""
    out = {name: total for name, (total, _, _) in _ACC.items()}
    _ACC.clear()
    return out


def pop_records():
    """``(spans, counts)``: the :class:`Span` records of the stages that
    ended and the :class:`Count` records made since the last call, which
    are then cleared.  A stage still open is left out, and its children
    name no parent."""
    done = _RECORDS[:]
    del _RECORDS[: len(done)]
    counts = _COUNTS[:]
    del _COUNTS[: len(counts)]
    index = {r[0]: i for i, r in enumerate(done)}
    spans = [Span(name, index.get(parent, -1), a, b)
             for _serial, name, parent, a, b in done]
    return spans, [Count(*c) for c in counts]


@contextlib.contextmanager
def maybe_trace():
    """``torch.profiler`` trace of the enclosed block if
    MASH_TPU_TORCH_TRACE is set.

    Only the trace machinery itself is guarded — exceptions raised by
    the traced body propagate unchanged.
    """
    trace_dir = os.environ.get("MASH_TPU_TORCH_TRACE")
    if not trace_dir:
        yield
        return

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        sys.stderr.write("Wrote torch profiler trace to %s\n" % path)
