"""The device's side of a traced window, read from ``torch.profiler``.

The profiler records the card's activity alone (kernels, copies,
fills) from just before the window opens to just after it closes, with
nothing queued before it.  From that come the device's busy time (the
union of the intervals in which an operation ran), its time by kind of
operation, and its idle gaps, each put down to the harness's host span
that was open at the gap's middle (``harness`` where none was).
"""

from __future__ import annotations

import bisect

# operation kinds by name, first match wins: the port's hand kernels,
# then PyTorch's sorts, top-k, elementwise kernels, reductions, copies
KINDS = (
    ("hash_windows", ("hash_windows",)),
    ("fold_sorted", ("fold_sorted",)),
    ("screen_count", ("screen_count",)),
    ("screen_table", ("screen_table",)),
    ("sketch_select", ("sketch_select",)),
    ("sort", ("sort", "radix")),
    ("topk", ("topk", "gatherTopK", "bitonic")),
    ("elementwise", ("elementwise",)),
    ("reduce", ("reduce",)),
    ("index", ("index", "scatter", "gather")),
    ("copy", ("memcpy", "memset", "copy")),
)


def kind(name: str) -> str:
    low = name.lower()
    for k, keys in KINDS:
        if any(key.lower() in low for key in keys):
            return k
    return "other"


def start():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof


def finish(prof, spans, t0_ns: int, t1_ns: int) -> dict:
    """Stop ``prof`` and read it: ``busy_s``, ``window_s``,
    ``device_ops`` and ``idle_gaps`` (each the ten largest, seconds) of
    the window from ``t0_ns`` to ``t1_ns`` (``time.time_ns``, the
    profiler's clock)."""
    import torch

    prof.stop()
    # the raw events, on the host's clock in ns (FunctionEvent trees cost
    # minutes for a window of 10^5 launches)
    intervals, by_kind, kinds = [], {}, {}
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        a, b = e.start_ns(), e.end_ns()
        intervals.append((a, b))
        name = e.name()
        k = kinds.get(name) or kinds.setdefault(name, kind(name))
        by_kind[k] = by_kind.get(k, 0.0) + (b - a) * 1e-9
    intervals.sort()
    busy, gaps, end = 0, [], t0_ns
    for a, b in intervals:
        if a > end:
            gaps.append((end, a))
        busy += max(0, b - max(a, end))
        end = max(end, b)
    if t1_ns > end:
        gaps.append((end, t1_ns))
    return {
        "busy_s": busy * 1e-9,
        "window_s": (t1_ns - t0_ns) * 1e-9,
        "device_ops": _top(by_kind),
        "idle_gaps": _top(_gaps_by_span(gaps, spans.records)),
        # how far the first operation starts after the window opens and
        # the last ends before it closes: a check of the two clocks
        "edges_s": [(intervals[0][0] - t0_ns) * 1e-9 if intervals else None,
                    (t1_ns - end) * 1e-9],
    }


def idle_pct(run):
    """A path's ``device_idle_pct``: the share of the traced window in
    which no operation ran on the card, in percent; None where the run
    was not traced."""
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def _gaps_by_span(gaps, records) -> dict:
    records = sorted(records, key=lambda r: r[1])
    starts = [r[1] for r in records]
    out = {}
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "harness"
        if i >= 0 and records[i][1] <= mid <= records[i][2]:
            name = records[i][0]
        out[name] = out.get(name, 0.0) + (b - a) * 1e-9
    return out


def _top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
