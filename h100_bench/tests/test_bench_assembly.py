"""The assembly cell (``sketch_grch38``) on the CPU: its layout at full
size without drawing a base, its data at a small size, the blocked
reference against the whole one and against the port, whole runs of its
driver (sound, the control, each fault), and its two program readers by
hand.  The stages they read (``transfer:upload``, ``engine:settle``)
nest inside stages other readers read, and move none of them."""

import time

import numpy as np
import pytest
import torch

from benchtest_util import SEED

from h100_bench import control, faults, harness
from h100_bench.generators import chromosomes
from h100_bench.outcome import Outcome
from h100_bench.reference.assembly import assembly_sketch, stream_blocks
from h100_bench.reference.sketch import genome_sketch
from mash_tpu_torch.core.engine import SketchEngine
from mash_tpu_torch.core.params import default_nucleotide_params
from mash_tpu_torch.io.ingest import IngestPipeline, ingest_available
from mash_tpu_torch.utils import profiling
from test_bench_program import COUNTS, HARNESS, NEW, OLD, SPANS

BENCH = harness.benchmark()
CELL = "sketch_grch38"
K = 21


def parts(mbase=None):
    c, config, traffic = harness.cell_parts(BENCH, CELL)
    if mbase:
        traffic = dict(traffic, genome_mbase=[mbase, mbase],
                       chunk_len=65536, batch_rows=4)
    return c, config, traffic


# -- the layout and the data ----------------------------------------------

def test_full_size_layout_keeps_the_published_sizes():
    _c, config, traffic = parts()
    gen = torch.Generator().manual_seed(SEED)
    recs = chromosomes.record_gaps(config, traffic, gen)
    lengths = [x for _, x in config["records"]]
    assert [x for x, _ in recs] == lengths
    assert sum(lengths) == config["total_bases"] == 3_088_286_401
    n_total = free = windows = 0
    for length, gaps in recs:
        edges = [x for g in gaps for x in g]
        assert edges == sorted(edges) and all(a < b for a, b in gaps)
        assert not gaps or (gaps[0][0] >= 0 and gaps[-1][1] <= length)
        n_total += sum(b - a for a, b in gaps)
        runs = chromosomes.free_runs(length, gaps)
        free += int(runs.sum())
        windows += int(np.maximum(runs - K + 1, 0).sum())
    assert n_total == config["n_total_bases"]
    assert free + n_total == config["total_bases"]
    # at the cell's rows of 1 MiB, whole rows lie in the runs of N
    longest = max(b - a for _, gaps in recs for a, b in gaps)
    assert longest > 2 * traffic["chunk_len"]
    assert 2.9e9 < windows < free


def test_other_seeds_move_the_gaps_not_the_sizes():
    _c, config, traffic = parts()
    a = chromosomes.record_gaps(config, traffic,
                                torch.Generator().manual_seed(SEED))
    b = chromosomes.record_gaps(config, traffic,
                                torch.Generator().manual_seed(3))
    assert [x for x, _ in a] == [x for x, _ in b]
    assert a != b
    total = [sum(e - s for _, g in r for s, e in g) for r in (a, b)]
    assert total[0] == total[1]


def test_small_data_follows_the_layout():
    _c, config, traffic = parts(2.0)
    data = chromosomes.generate(config, traffic, SEED, torch.device("cpu"))
    again = chromosomes.generate(config, traffic, SEED, torch.device("cpu"))
    other = chromosomes.generate(config, traffic, 3, torch.device("cpu"))
    seq = np.concatenate(data.genomes[0])
    assert np.array_equal(seq, np.concatenate(again.genomes[0]))
    assert not np.array_equal(seq, np.concatenate(other.genomes[0]))
    assert data.lengths().tolist() == other.lengths().tolist()
    n = [sum(int((r == ord("N")).sum()) for r in d.genomes[0])
         for d in (data, other)]
    assert n[0] == n[1]
    assert set(np.unique(seq).tobytes()) <= set(b"ACGTNacgt")
    text = data.fasta(0)
    assert text.startswith(b">chr1\n") and b"\n>chrM\n" in text
    assert max(len(x) for x in text.split(b"\n")) == 50


def test_free_windows_are_counted_exactly():
    _c, config, traffic = parts(0.4)
    data = chromosomes.generate(config, traffic, SEED, torch.device("cpu"))
    want = 0
    for r in data.genomes[0]:
        bad = np.concatenate([[0], np.cumsum(r == ord("N"))])
        if len(r) >= K:
            want += int((bad[K:] == bad[:-K]).sum())
    assert data.windows(0, K) == want


# -- the blocked reference -------------------------------------------------

ROW, ROWS = 4096, 8


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A 4.2 Mbase assembly (chrM keeps 23 bases, one window more than k
    needs) and the port's sketch of its FASTA file, in batches of 8 rows
    of 4096 bytes."""
    if not ingest_available():
        pytest.skip("native ingest library unavailable")
    _c, config, traffic = parts(4.2)
    data = chromosomes.generate(config, traffic, SEED, torch.device("cpu"))
    path = tmp_path_factory.mktemp("assembly") / "grch38_small.fa"
    path.write_bytes(data.fasta(0))
    pipe = IngestPipeline([str(path)], K, ROW, ROWS, pack_mode=1)
    try:
        batches = list(pipe.batches())
    finally:
        pipe.close()
    eng = SketchEngine(default_nucleotide_params(), chunk_len=ROW,
                       device="cpu")
    ref = eng.state_to_ref(eng.fold_batches(eng.empty_state(), batches,
                                            packed=True))
    return config, data, ref


@pytest.mark.parametrize("block", [1 << 20, 3_000_000, 1 << 30])
def test_the_port_equals_the_blocked_reference(small, block):
    config, data, ref = small
    h, c = assembly_sketch(data.genomes[0], config, "cpu", block=block)
    assert len(h) == 1000
    np.testing.assert_array_equal(ref.hashes, h)
    np.testing.assert_array_equal(ref.counts, c)


def _stream(records):
    return np.concatenate([np.append(r, np.uint8(0)) for r in records])


def _edge_in(records, where):
    """A block size whose first block ends inside an N run, inside a
    run of bases or on a record's end."""
    seq = _stream(records)
    if where == "n_run":
        at = np.flatnonzero(seq == ord("N"))
    elif where == "bases":
        at = np.flatnonzero((seq > 0) & (seq != ord("N")))
    else:
        at = np.flatnonzero(seq == 0) + 1
    return int(at[len(at) // 2])


@pytest.mark.parametrize("where", ["n_run", "bases", "record_end"])
def test_blocked_reference_equals_the_whole(where):
    _c, config, traffic = parts(0.4)
    data = chromosomes.generate(config, traffic, SEED + 1,
                                torch.device("cpu"))
    recs = data.genomes[0]
    block = _edge_in(recs, where)
    seq = _stream(recs)
    pieces = list(stream_blocks(recs, K, block))
    assert len(pieces) >= 2
    assert np.array_equal(pieces[0], seq[:block])
    assert np.array_equal(pieces[1][:K - 1], seq[block - K + 1: block])
    small_s = dict(config, sketch_size=300)
    for cfg in (config, small_s):
        whole = genome_sketch(recs, cfg, "cpu")
        h, c = assembly_sketch(recs, cfg, "cpu", block=block)
        np.testing.assert_array_equal(h, whole[0])
        np.testing.assert_array_equal(c, whole[1])


# -- whole runs ------------------------------------------------------------

def run(seconds=1):
    c, config, traffic = parts(2.0)
    result, _checks = harness.run_cell(
        c, config, traffic, SEED, seconds, False, torch.device("cpu"),
        time.perf_counter(), harness.metrics_of(BENCH, c, False))
    return result


def test_a_sound_program_is_correct():
    result = run()
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {"setup_s", "sketch_bases_per_s"}


def test_the_control_is_not_correct():
    _c, config, traffic = parts(2.0)
    found = control.control(config, traffic, SEED, torch.device("cpu"))
    limits = harness.path_modules(traffic)[2].LIMITS
    assert any(v > limits[k] for k, v in found.items())


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_a_broken_program_is_not_correct(fault):
    with faults.planted("assembly", fault):
        result = run()
    assert not result["correct"] and result["failed"] > 0


# -- the two program readers ---------------------------------------------

# test_bench_program's records with the two new stages around what they
# hold: an upload around each slot's wait, a settle in a fold_batch, an
# upload of the screen's outside any stage
WITH_NEW = [
    ("wait:upload_slot", 1, 1200, 1250),        # 0
    ("transfer:upload", 3, 1190, 1260),         # 1
    ("engine:settle", 3, 1300, 1380),           # 2
    ("engine:fold_batch", 4, 1100, 1400),       # 3
    ("engine:fold_batches", -1, 1050, 1500),    # 4
    ("wait:readback", 7, 1600, 1700),           # 5
    ("wait:to_host", 7, 1750, 1800),            # 6
    ("engine:state_to_ref", -1, 1550, 1850),    # 7
    ("transfer:upload", 9, 2110, 2140),         # 8
    ("engine:fold_batch", 10, 2100, 2300),      # 9
    ("engine:fold_batches", -1, 2000, 2400),    # 10
    ("wait:to_host", 12, 2500, 2600),           # 11
    ("engine:state_to_ref", -1, 2450, 2650),    # 12
    ("wait:upload_slot", 14, 2900, 2950),       # 13
    ("transfer:upload", -1, 2890, 2960),        # 14
    ("wait:readback", 16, 3100, 3300),          # 15
    ("screen:fold_batch", -1, 3000, 3500),      # 16
    ("engine:fold_batch", -1, 100, 200),        # 17: set-up
]


def synthetic_run(spans, monkeypatch):
    monkeypatch.setattr(profiling, "pop_records",
                        lambda: (list(spans), list(COUNTS)))
    records = harness.Spans()
    for name, a, b in HARNESS:
        records.records.append((name, a, b))
        records.totals[name] = records.totals.get(name, 0.0) + (b - a) * 1e-9
        records.calls[name] = records.calls.get(name, 0) + 1
    outcome = Outcome(units=2, bases=10**9, windows=10**9)
    return harness.Run({"kmer_size": K}, 12.5, 1e-5, outcome, records,
                       {"engine:fold_batch": 0.5, "screen:fold_batch": 0.25},
                       {"busy_s": 2.0, "window_s": 10.0})


def test_the_new_stages_only_wrap_what_was_there():
    strip = [s for s in WITH_NEW
             if s[0] not in ("transfer:upload", "engine:settle")]
    assert [(n, a, b) for n, _p, a, b in strip] == [
        (n, a, b) for n, _p, a, b in SPANS]


@pytest.mark.parametrize("name,want", [
    # uploads 70, 30 and 70 ns less the waits in two of them (50 each)
    ("upload_ms_per_gbase.assembly", 70e-6),
    # one settle of 80 ns over the window's two fold_batch stages
    ("settle_ms_per_batch.assembly", 40e-6),
])
def test_each_new_reader_by_hand(monkeypatch, name, want):
    got = harness.reader(name)(synthetic_run(WITH_NEW, monkeypatch))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", ["upload_ms_per_gbase.assembly",
                                  "settle_ms_per_batch.assembly"])
def test_a_program_without_the_stages_reads_none(monkeypatch, name):
    assert harness.reader(name)(synthetic_run(SPANS, monkeypatch)) is None


@pytest.mark.parametrize("name", sorted(set(NEW) | set(OLD)))
def test_older_readers_do_not_move(monkeypatch, name):
    before = harness.reader(name)(synthetic_run(SPANS, monkeypatch))
    after = harness.reader(name)(synthetic_run(WITH_NEW, monkeypatch))
    assert after == before


def test_the_cell_reports_the_sketch_paths_readers():
    """The cell reads the sketch path's dispatch, read-back, idle share
    and roofline (fed with the exact windows) and its own two."""
    c, _config, _traffic = parts()
    names = {m["name"] for m in harness.metrics_of(BENCH, c, True)}
    assert names == {"fold_dispatch_ms_per_gbase.sketch",
                     "sketch_read_ms_per_genome.sketch",
                     "roofline_pct.sketch", "device_idle_pct.sketch",
                     "upload_ms_per_gbase.assembly",
                     "settle_ms_per_batch.assembly"}
