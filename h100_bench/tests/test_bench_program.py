"""The readers of the program's own stages and counters
(``h100_bench/program.py``), on a synthetic run: each new metric by
hand, a program that keeps no records reading None, the idle gaps put
down to the innermost span, and the harness's ``idle_gaps`` and every
older reader unchanged on the same input."""

import pytest

from benchtest_util import ROOT  # noqa: F401  (the repository on the path)

from h100_bench import harness, program, trace
from h100_bench.outcome import Outcome
from mash_tpu_torch.utils import profiling

# program records in the order they ended, ns: two genomes, then one
# screen batch; a record of set-up and counts outside the window
SPANS = [
    ("wait:upload_slot", 1, 1200, 1250),        # 0
    ("engine:fold_batch", 2, 1100, 1400),       # 1
    ("engine:fold_batches", -1, 1050, 1500),    # 2: self 150
    ("wait:readback", 5, 1600, 1700),           # 3
    ("wait:to_host", 5, 1750, 1800),            # 4
    ("engine:state_to_ref", -1, 1550, 1850),    # 5
    ("engine:fold_batch", 7, 2100, 2300),       # 6
    ("engine:fold_batches", -1, 2000, 2400),    # 7: self 200
    ("wait:to_host", 9, 2500, 2600),            # 8
    ("engine:state_to_ref", -1, 2450, 2650),    # 9
    ("wait:upload_slot", -1, 2900, 2950),       # 10
    ("wait:readback", 12, 3100, 3300),          # 11
    ("screen:fold_batch", -1, 3000, 3500),      # 12
    ("engine:fold_batch", -1, 100, 200),        # 13: set-up
]
COUNTS = [
    ("sketch:rows_folded", 4, 150), ("sketch:rows_recomputed", 4, 150),
    ("sketch:rows_folded", 3, 1300), ("sketch:rows_recomputed", 1, 1650),
    ("sketch:rows_folded", 5, 2200), ("sketch:rows_recomputed", 0, 2550),
    ("sketch:rows_folded", 100, 20000),  # after the window
]
HARNESS = [("generate", 0, 50), ("setup", 60, 1000), ("fold", 1040, 1520),
           ("read_sketch", 1540, 1860), ("fold", 1990, 2410),
           ("read_sketch", 2440, 2660), ("stream", 2800, 3600),
           ("reference", 10000, 12000)]


def synthetic_run():
    spans = harness.Spans()
    for name, a, b in HARNESS:
        spans.records.append((name, a, b))
        spans.totals[name] = spans.totals.get(name, 0.0) + (b - a) * 1e-9
        spans.calls[name] = spans.calls.get(name, 0) + 1
    outcome = Outcome(units=2, bases=10**9, windows=10**9)
    return harness.Run({}, 12.5, 1e-5, outcome, spans,
                       {"engine:fold_batch": 0.5, "screen:fold_batch": 0.25},
                       {"busy_s": 2.0, "window_s": 10.0})


@pytest.fixture
def records(monkeypatch):
    monkeypatch.setattr(profiling, "pop_records",
                        lambda: (list(SPANS), list(COUNTS)))


NEW = {
    "fold_self_ms_per_genome.sketch": 175e-6,
    "fold_dispatch_self_ms_per_gbase.sketch": 450e-6,
    "state_to_ref_ms_per_genome.sketch": 250e-6,
    "host_wait_pct.sketch": 5.5,
    "recompute_row_pct.sketch": 12.5,
    "screen_dispatch_self_ms_per_gbase.screen": 300e-6,
    "host_wait_pct.screen": 5.5,
    "recompute_row_pct.screen": 12.5,
}
OLD = {
    "fold_dispatch_ms_per_gbase.sketch": 500.0,
    "screen_dispatch_ms_per_gbase.screen": 250.0,
    "sketch_read_ms_per_genome.sketch": 1e3 * 540e-9 / 2,
    "report_s.screen": None,
    "db_build_s": None,
    "device_idle_pct.sketch": 80.0,
    "device_idle_pct.screen": 80.0,
    "sketch_bases_per_s": 1e14,
    "screen_bases_per_s": 1e14,
    "setup_s": 12.5,
}


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_new_reader_by_hand(records, name):
    assert harness.reader(name)(synthetic_run()) == pytest.approx(NEW[name])


def test_the_new_readers_are_the_benchmarks():
    bench = harness.benchmark()
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        assert listed[name]["source"] == "program_span"
        assert len(listed[name]["workloads"]) == 1


def test_readers_share_one_pop(monkeypatch):
    calls = []
    monkeypatch.setattr(profiling, "pop_records", lambda: calls.append(1)
                        or (list(SPANS), list(COUNTS)))
    run = synthetic_run()
    for name in sorted(NEW):
        assert harness.reader(name)(run) is not None
    assert calls == [1]


@pytest.mark.parametrize("name", sorted(NEW))
def test_a_program_without_records_reads_none(monkeypatch, name):
    monkeypatch.delattr(profiling, "pop_records")
    assert harness.reader(name)(synthetic_run()) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_an_empty_window_reads_none_or_zero(monkeypatch, name):
    monkeypatch.setattr(profiling, "pop_records", lambda: ([], []))
    got = harness.reader(name)(synthetic_run())
    assert got == (0.0 if name.startswith("host_wait_pct") else None)


@pytest.mark.parametrize("name", sorted(OLD))
def test_old_readers_unchanged(records, name):
    got = harness.reader(name)(synthetic_run())
    assert got == (None if OLD[name] is None else pytest.approx(OLD[name]))


def test_the_window_holds_only_the_window():
    w = program.in_window(SPANS, COUNTS, *program.bounds(HARNESS))
    assert len(w.spans) == 13 and w.counts == {
        "sketch:rows_folded": 8, "sketch:rows_recomputed": 1}
    # parents point into the list kept
    assert w.spans[0][1] == 1 and w.spans[1][1] == 2
    cut = program.in_window(SPANS, COUNTS, 1060, None)
    names = [s[0] for s in cut.spans]
    assert "engine:fold_batches" in names  # the second genome's
    assert cut.spans[names.index("engine:fold_batch")][1] == -1


def test_union_and_self_time():
    assert program.union_ns([(0, 10), (5, 20), (30, 40), (31, 35)]) == 30
    assert program.union_ns([]) == 0
    w = program.in_window(SPANS, COUNTS, *program.bounds(HARNESS))
    assert program.self_ns(w, "engine:fold_batches") == 350
    assert program.self_ns(w, "engine:state_to_ref") == 250
    assert program.less_waits_ns(w, "engine:fold_batches") == 800
    assert program.wait_ns(w) == 550


# -- idle gaps ----------------------------------------------------------------

GAPS = [
    (1055, 1095),  # in fold_batches before its fold_batch
    (1210, 1240),  # in the upload wait
    (1420, 1480),  # in fold_batches after its fold_batch ended
    (1505, 1515),  # in the harness's fold, outside the program's spans
    (1860, 1990),  # between the harness's spans
    (2460, 2490),  # in state_to_ref before its wait
]


def test_gaps_go_to_the_innermost_span():
    w = program.in_window(SPANS, COUNTS, *program.bounds(HARNESS))
    got = program.innermost_gaps(GAPS, w.spans, HARNESS)
    assert got == pytest.approx({
        "engine:fold_batches": 100e-9, "wait:upload_slot": 30e-9,
        "fold": 10e-9, "harness": 130e-9, "engine:state_to_ref": 30e-9})


def test_program_gaps_inside_a_harness_span_sum_to_its_gap():
    w = program.in_window(SPANS, COUNTS, *program.bounds(HARNESS))
    prog = program.innermost_gaps(GAPS, w.spans, HARNESS)
    old = trace._gaps_by_span(GAPS, HARNESS)
    inside_fold = sum(v for k, v in prog.items()
                      if k.startswith(("engine:fold", "wait:upload")))
    assert inside_fold + prog["fold"] == pytest.approx(old["fold"])
    assert sum(prog.values()) == pytest.approx(sum(old.values()))


def test_idle_gaps_unchanged():
    """``trace._gaps_by_span`` as it was: the harness's span that started
    last before a gap's middle, ``harness`` where that one had ended."""
    assert trace._gaps_by_span(GAPS, HARNESS) == pytest.approx({
        "fold": 140e-9, "harness": 130e-9, "read_sketch": 30e-9})
    # nested spans, which it was not written for, keep their old labels
    nested = [("outer", 0, 100), ("inner", 10, 20)]
    assert trace._gaps_by_span([(40, 60)], nested) == {"harness": 20e-9}
    assert program.innermost_gaps([(40, 60)], [], nested) == {
        "outer": 20e-9}
