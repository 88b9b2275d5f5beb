"""Tracing and per-stage timing.

Every CLI invocation can capture a PyTorch profiler trace and a
per-stage wall-clock report:

- ``MASH_TPU_TORCH_TRACE=<dir>``: write a Chrome trace of the whole
  command (host ops and, on a GPU, CUDA kernels) to
  ``<dir>/trace.json`` (view in ``chrome://tracing`` or Perfetto).
- ``MASH_TPU_TORCH_TIMINGS=1``: print a per-stage wall-clock summary to
  stderr at command exit.

Stages are annotated in library code with the :func:`stage` context
manager, which is a no-op (one environment lookup) unless timing is
enabled.  Device work is asynchronous, so a stage's wall clock covers
what it enqueued and whatever it waited for, not its device time.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import sys
import time
from collections import defaultdict

_TIMINGS_ENABLED = bool(os.environ.get("MASH_TPU_TORCH_TIMINGS"))
_ACC: dict = defaultdict(lambda: [0.0, 0])
_REPORT_REGISTERED = False


def stage_report(out=None):
    """Print accumulated per-stage timings (stderr by default)."""
    out = out or sys.stderr
    if not _ACC:
        return
    width = max(len(k) for k in _ACC)
    out.write("-- mash-tpu-torch stage timings --\n")
    for name, (total, calls) in sorted(
        _ACC.items(), key=lambda kv: -kv[1][0]
    ):
        out.write(
            "%-*s  %9.3f s  (%d call%s)\n"
            % (width, name, total, calls, "s" if calls != 1 else "")
        )


def pop_stage_totals() -> dict:
    """``{stage: seconds}`` accumulated so far; starts the next count
    from zero (a caller timing several commands reads one at a time)."""
    out = {name: total for name, (total, _) in _ACC.items()}
    _ACC.clear()
    return out


@contextlib.contextmanager
def stage(name: str):
    """Accumulate wall-clock for a named stage (cheap when disabled)."""
    global _REPORT_REGISTERED
    if not _TIMINGS_ENABLED:
        yield
        return
    if not _REPORT_REGISTERED:
        _REPORT_REGISTERED = True
        atexit.register(stage_report)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        cell = _ACC[name]
        cell[0] += time.perf_counter() - t0
        cell[1] += 1


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
