"""The program's own stages and counters in a traced window.

With ``--trace 1`` the program's timings are on, and
``mash_tpu_torch.utils.profiling`` keeps a record of each stage (name,
parent, start and end on ``time.time_ns``, the clock of the harness's
spans and of the profiler) and of each count.  The readers of the
metrics that read them take :func:`of` a run: the records that lie
between the end of the harness's ``setup`` span and the start of its
``reference`` span, which hold the window and nothing of set-up or of
the comparison.  The first reader pops the records from the program;
the others read the copy kept on the run.

A program that keeps no records (one older than ``pop_records``) gives
None, and so does each reader.
"""

from __future__ import annotations

import heapq
from typing import NamedTuple

WAIT = "wait:"


class Window(NamedTuple):
    """``spans``: ``(name, parent, start_ns, end_ns)`` with ``parent``
    an index into ``spans`` or -1; ``counts``: ``{counter: total}``."""

    spans: list
    counts: dict


def of(run):
    """The :class:`Window` of the program's records in ``run``, or None
    where the program keeps none."""
    got = getattr(run, "_program_window", None)
    if got is None:
        got = run._program_window = (_pop(run),)
    return got[0]


def _pop(run):
    try:
        from mash_tpu_torch.utils import profiling
    except ImportError:
        return None
    pop = getattr(profiling, "pop_records", None)
    if pop is None:
        return None
    spans, counts = pop()
    lo, hi = bounds(run.spans.records)
    return in_window(spans, counts, lo, hi)


def bounds(harness_records):
    """``(lo, hi)`` in ns: the end of the harness's ``setup`` span and the
    start of its ``reference`` span (None where the run has none)."""
    lo = max((b for name, _a, b in harness_records if name == "setup"),
             default=None)
    hi = min((a for name, a, _b in harness_records if name == "reference"),
             default=None)
    return lo, hi


def in_window(spans, counts, lo=None, hi=None) -> Window:
    """The records of ``spans`` (``(name, parent, start_ns, end_ns)``)
    and ``counts`` (``(name, n, at_ns)``) that lie within ``[lo, hi]``,
    each parent index pointing into the list returned (-1 where the
    parent lies outside)."""
    lo = float("-inf") if lo is None else lo
    hi = float("inf") if hi is None else hi
    index, kept = {}, []
    for i, (name, parent, a, b) in enumerate(spans):
        if lo <= a and b <= hi:
            index[i] = len(kept)
            kept.append((name, parent, a, b))
    kept = [(name, index.get(parent, -1), a, b)
            for name, parent, a, b in kept]
    totals: dict = {}
    for name, n, at in counts:
        if lo <= at <= hi:
            totals[name] = totals.get(name, 0) + n
    return Window(kept, totals)


def union_ns(intervals) -> int:
    """Nanoseconds covered by the union of ``(start, end)`` intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _children(spans) -> list:
    kids = [[] for _ in spans]
    for i, (_name, parent, _a, _b) in enumerate(spans):
        if parent >= 0:
            kids[parent].append(i)
    return kids


def spans_named(window: Window, name: str) -> list:
    return [s for s in window.spans if s[0] == name]


def self_ns(window: Window, name: str) -> int:
    """The self time of the spans named ``name``, summed: each one's
    duration less the union of its child spans."""
    kids = _children(window.spans)
    total = 0
    for i, (n, _p, a, b) in enumerate(window.spans):
        if n == name:
            total += b - a - union_ns(
                window.spans[j][2:] for j in kids[i])
    return total


def less_waits_ns(window: Window, name: str) -> int:
    """The duration of the spans named ``name``, summed, less the union
    of the ``wait:*`` spans nested in each."""
    kids = _children(window.spans)
    total = 0
    for i, (n, _p, a, b) in enumerate(window.spans):
        if n != name:
            continue
        waits, todo = [], list(kids[i])
        while todo:
            j = todo.pop()
            if window.spans[j][0].startswith(WAIT):
                waits.append(window.spans[j][2:])
            else:
                todo.extend(kids[j])
        total += b - a - union_ns(waits)
    return total


def wait_ns(window: Window) -> int:
    """Nanoseconds in which the host waited on the card: the union of
    the ``wait:*`` spans."""
    return union_ns(s[2:] for s in window.spans if s[0].startswith(WAIT))


def innermost_gaps(gaps, program_spans, harness_records) -> dict:
    """Seconds of idle time by name: each ``(start_ns, end_ns)`` gap put
    down to the innermost program span open at its middle (the one that
    started last among those open then), else to the innermost harness
    span (``(name, start_ns, end_ns)``), else to ``harness``."""
    prog = sorted((a, b, name) for name, _p, a, b in program_spans)
    harn = sorted((a, b, name) for name, a, b in harness_records)
    out: dict = {}
    order = sorted(gaps, key=lambda g: g[0] + g[1])
    mids = [(a + b) // 2 for a, b in order]
    names_p = _innermost(mids, prog)
    names_h = _innermost(mids, harn)
    for (a, b), p, h in zip(order, names_p, names_h):
        name = p or h or "harness"
        out[name] = out.get(name, 0.0) + (b - a) * 1e-9
    return out


def _innermost(points, spans) -> list:
    """For ascending ``points``, the name of the span of ``spans``
    (``(start, end, name)``, sorted) that started last among those that
    cover the point, or None."""
    out, heap, i = [], [], 0
    for t in points:
        while i < len(spans) and spans[i][0] <= t:
            a, b, name = spans[i]
            heapq.heappush(heap, (-a, b, name))
            i += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def wait_pct(run):
    """A path's ``host_wait_pct``: :func:`wait_ns` over the window, in
    percent; None where the program keeps no records."""
    w = of(run)
    if w is None:
        return None
    return 100.0 * wait_ns(w) * 1e-9 / run.window_s


def recompute_pct(run):
    """A path's ``recompute_row_pct``: the counter
    ``sketch:rows_recomputed`` over ``sketch:rows_folded``, in percent;
    None where no row was folded."""
    w = of(run)
    folded = w and w.counts.get("sketch:rows_folded")
    if not folded:
        return None
    return 100.0 * w.counts.get("sketch:rows_recomputed", 0) / folded
