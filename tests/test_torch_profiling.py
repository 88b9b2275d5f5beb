"""The port's stage recorder (``mash_tpu_torch.utils.profiling``) on the
CPU: stages nest with their parent, keep their self time and their times
on ``time.time_ns``, counters add up, each pop clears what it owns, and
with timings off nothing is kept.  Then the paths the benchmark reads:
``SketchEngine.fold_batches`` and ``state_to_ref``, the deferred
certificate's recomputed rows, and the screen fold.

Timings are switched by the module's own flag (``monkeypatch``), as the
environment variable would have set it at import."""

import io
import time

import numpy as np
import pytest
import torch

from mash_tpu_torch.core import engine as te
from mash_tpu_torch.core.params import default_nucleotide_params
from mash_tpu_torch.ops import screen_ops
from mash_tpu_torch.ops import sketch_ops
from mash_tpu_torch.utils import profiling

ACGT = np.frombuffer(b"ACGT", np.uint8)
K = 21


def _clear():
    profiling.pop_records()
    profiling.pop_stage_totals()


@pytest.fixture
def on(monkeypatch):
    """Timings on, with nothing recorded before or left after."""
    monkeypatch.setattr(profiling, "_TIMINGS_ENABLED", True)
    _clear()
    yield
    _clear()


@pytest.fixture
def off(monkeypatch):
    monkeypatch.setattr(profiling, "_TIMINGS_ENABLED", False)
    _clear()
    yield
    _clear()


def _named(spans, name):
    return [i for i, s in enumerate(spans) if s.name == name]


# -- the recorder -------------------------------------------------------------

def test_spans_nest_with_their_parent(on):
    with profiling.stage("outer"):
        with profiling.stage("first"):
            with profiling.stage("inner"):
                pass
        with profiling.stage("second"):
            pass
    with profiling.stage("alone"):
        pass
    spans, counts = profiling.pop_records()
    assert counts == []
    assert [s.name for s in spans] == ["inner", "first", "second", "outer",
                                       "alone"]
    (outer,), (first,) = _named(spans, "outer"), _named(spans, "first")
    assert spans[_named(spans, "inner")[0]].parent == first
    assert spans[first].parent == outer
    assert spans[_named(spans, "second")[0]].parent == outer
    assert spans[outer].parent == -1 and spans[-1].parent == -1
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def test_a_thread_has_its_own_stack(on):
    import threading

    with profiling.stage("main"):
        t = threading.Thread(target=lambda: profiling.stage("other")
                             .__enter__().__exit__(None, None, None))
        t.start()
        t.join()
    spans, _ = profiling.pop_records()
    assert spans[_named(spans, "other")[0]].parent == -1


class _Clock:
    """``time.time_ns`` stand-in: each call reads the next value."""

    def __init__(self, ticks):
        self.ticks = iter(ticks)

    def time_ns(self):
        return next(self.ticks)


def test_self_time_is_the_duration_less_the_children(on, monkeypatch):
    # outer 0..10 s; children 1..3 s and 5..6 s, a grandchild 1.5..2.5 s
    s = 10**9
    ticks = [0, 1 * s, s * 3 // 2, s * 5 // 2, 3 * s, 5 * s, 6 * s, 10 * s]
    monkeypatch.setattr(profiling, "time", _Clock(ticks))
    with profiling.stage("outer"):
        with profiling.stage("child"):
            with profiling.stage("grandchild"):
                pass
        with profiling.stage("child"):
            pass
    out = io.StringIO()
    profiling.stage_report(out)
    lines = {ln.split()[0]: ln.split() for ln in out.getvalue().splitlines()
             if not ln.startswith("--")}
    # name, total, "s", "self", self, "s", calls
    assert lines["outer"][1] == "10.000" and lines["outer"][4] == "7.000"
    assert lines["child"][1] == "3.000" and lines["child"][4] == "2.000"
    assert lines["grandchild"][4] == "1.000"
    assert lines["child"][6] == "(2"
    spans, _ = profiling.pop_records()
    assert [(x.start_ns, x.end_ns) for x in spans] == [
        (s * 3 // 2, s * 5 // 2), (1 * s, 3 * s), (5 * s, 6 * s),
        (0, 10 * s)]


def test_records_are_on_time_ns(on):
    a = time.time_ns()
    with profiling.stage("x"):
        time.sleep(0.002)
    profiling.count("c")
    b = time.time_ns()
    (span,), (cnt,) = profiling.pop_records()
    assert a <= span.start_ns < span.end_ns <= b
    assert span.end_ns - span.start_ns >= 2_000_000
    assert a <= cnt.at_ns <= b
    assert profiling.pop_stage_totals()["x"] == pytest.approx(
        (span.end_ns - span.start_ns) * 1e-9)


def test_counters_add_up_and_each_pop_clears_what_it_owns(on):
    profiling.count("rows", 2)
    profiling.count("rows", 3)
    profiling.count("other")
    with profiling.stage("x"):
        pass
    out = io.StringIO()
    profiling.stage_report(out)
    assert "rows" in out.getvalue() and " 5\n" in out.getvalue()
    # the totals' pop leaves the records, the records' pop the totals
    assert set(profiling.pop_stage_totals()) == {"x"}
    assert profiling.pop_stage_totals() == {}
    with profiling.stage("y"):
        pass
    spans, counts = profiling.pop_records()
    assert [s.name for s in spans] == ["x", "y"]
    assert profiling.counter_totals(counts) == {"rows": 5, "other": 1}
    assert profiling.pop_records() == ([], [])
    assert set(profiling.pop_stage_totals()) == {"y"}


def test_a_span_open_at_the_pop_is_left_out(on):
    with profiling.stage("open"):
        with profiling.stage("done"):
            pass
        spans, _ = profiling.pop_records()
        assert [(s.name, s.parent) for s in spans] == [("done", -1)]
    spans, _ = profiling.pop_records()
    assert [s.name for s in spans] == ["open"]


def test_off_records_nothing_and_shares_one_context(off):
    a, b = profiling.stage("a"), profiling.stage("b")
    assert a is b
    with a:
        with profiling.stage("c"):
            pass
    profiling.count("rows", 7)
    assert profiling.pop_records() == ([], [])
    assert profiling.pop_stage_totals() == {}
    out = io.StringIO()
    profiling.stage_report(out)
    assert out.getvalue() == ""


# -- the paths the benchmark reads -------------------------------------------

def _rows(rng, n, width=20 * 1024):
    rows = ACGT[rng.integers(0, 4, (n, width))]
    rows[1, 2048 + K - 1:] = 0  # a short tail row: it lacks the certificate
    return np.ascontiguousarray(rows)


def _engine():
    p = default_nucleotide_params()
    p.min_hashes_per_window = 1300
    return te.SketchEngine(p, device="cpu")


def test_fold_batches_counts_the_rows_it_folded(on):
    rng = np.random.default_rng(3)
    rows = _rows(rng, 5)
    pad = np.zeros((3, rows.shape[1]), np.uint8)
    batches = [rows[:3], np.concatenate([rows[3:], pad])]  # 2 + 3 padding
    eng = _engine()
    ref = eng.state_to_ref(eng.fold_batches(eng.empty_state(), batches))
    assert len(ref.hashes)
    spans, counts = profiling.pop_records()
    # every row given is folded, the 3 zero padding rows too
    assert profiling.counter_totals(counts)["sketch:rows_folded"] == 8
    (whole,) = _named(spans, "engine:fold_batches")
    each = _named(spans, "engine:fold_batch")
    assert len(each) == 2 and all(spans[i].parent == whole for i in each)
    (read,) = _named(spans, "engine:state_to_ref")
    waits = _named(spans, "wait:to_host")
    assert len(waits) == 2 and all(spans[i].parent == read for i in waits)
    totals = profiling.pop_stage_totals()
    assert totals["engine:fold_batches"] >= totals["engine:fold_batch"]


def test_the_certificate_counts_the_rows_it_recomputes(on, monkeypatch):
    seen = {"rows": 0}
    states = sketch_ops.Uncertified.states

    def counted(self):
        got = states(self)
        if got is not None:
            seen["rows"] += int(got[0].numel())
        return got

    monkeypatch.setattr(sketch_ops.Uncertified, "states", counted)
    rng = np.random.default_rng(4)
    rows = _rows(rng, 6)
    eng = _engine()
    eng.state_to_ref(eng.fold_batches(eng.empty_state(),
                                      [rows[:2], rows[2:4], rows[4:]]))
    _spans, counts = profiling.pop_records()
    totals = profiling.counter_totals(counts)
    assert seen["rows"] == 1  # the tail row
    assert totals["sketch:rows_recomputed"] == seen["rows"]
    assert totals["sketch:rows_folded"] == 6


def test_the_screen_fold_counts_rows(on):
    rng = np.random.default_rng(5)
    rows = ACGT[rng.integers(0, 4, (5, 4096))]
    p = default_nucleotide_params()
    db = np.unique(rng.integers(0, 2**63, 100, dtype=np.uint64))
    _fold, fold_rows, counts, finalize = screen_ops.make_screen_fold(
        p, db, p.sketch_size, device="cpu")
    state = sketch_ops.empty_state(p.sketch_size)
    for b in (rows[:3], rows[3:]):
        counts, state = fold_rows(counts, state, torch.from_numpy(b))
    finalize(counts)
    spans, cnt = profiling.pop_records()
    assert profiling.counter_totals(cnt)["sketch:rows_folded"] == 5
    assert len(_named(spans, "screen:fold_batch")) == 2
    assert len(_named(spans, "wait:to_host")) == 1
