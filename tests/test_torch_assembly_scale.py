"""A whole reference assembly through the port's sketch path, on the CPU
at a small size.

The input is GRCh38-shaped: its 25 primary records at their proportions,
scaled to 4.2 Mbase, so that one (chrM) is shorter than a row; runs of N
at the chromosomes' ends, on the acrocentric short arms, in the
heterochromatin blocks and inside, the longer ones covering whole rows;
soft-masked runs over about half the other bases; rows of 4096 bytes in
batches of 8, so the file spans far more than 20 batches.  It is
sketched as the CLI's fast path does (``IngestPipeline`` ->
``SketchEngine.fold_batches`` -> ``state_to_ref``), packed and raw, and
must equal, hashes and counts, ``mash_tpu``'s sketch of the same file.
A sketch of 3,088,286,401 bases keeps its length through ``.msh`` and
``info`` prints what ``mash_tpu``'s does.  Last, the stages
``transfer:upload`` and ``engine:settle`` nest inside
``engine:fold_batch``, with their waits inside them, and the upload
sends an ingest batch in pinned memory as it is and holds it until its
copy is done.
"""

import contextlib
import io
import weakref

import numpy as np
import pytest
import torch

from mash_tpu.__main__ import main as jax_main
from mash_tpu.core.engine import SketchEngine as JaxEngine
from mash_tpu.core.params import default_nucleotide_params as jax_params
from mash_tpu.io.ingest import IngestPipeline as JaxIngest
from mash_tpu_torch.__main__ import main as torch_main
from mash_tpu_torch.core import engine as te
from mash_tpu_torch.core.params import default_nucleotide_params
from mash_tpu_torch.core.sketch import SketchRef
from mash_tpu_torch.io import capnp_msh
from mash_tpu_torch.io.ingest import IngestPipeline, ingest_available
from mash_tpu_torch.ops import sketch_kernel as sk
from mash_tpu_torch.ops import sketch_ops
from mash_tpu_torch.ops.kmers import hash_kw
from mash_tpu_torch.utils import profiling, transfer

K = 21
ROW = 4096
ROWS = 8
SEED = 2**31 + 777
GRCH38_BASES = 3_088_286_401
# GRCh38's primary records, chr1-22, X, Y and M, in bases
GRCH38 = [248956422, 242193529, 198295559, 190214555, 181538259,
          170805979, 159345973, 145138636, 138394717, 133797422,
          135086622, 133275309, 114364328, 107043718, 101991189,
          90338345, 83257441, 80373285, 58617616, 64444167, 46709983,
          50818468, 156040895, 57227415, 16569]
NAMES = ["chr%s" % n for n in [*range(1, 23), "X", "Y", "M"]]
# runs of N at the start of the acrocentric short arms (chr13, 14, 15,
# 21, 22) and heterochromatin blocks (chr1, 9, 16, Y), in bases
ARMS = {12: 16e6, 13: 16e6, 14: 17e6, 20: 5e6, 21: 10.5e6}
BLOCKS = {0: 18e6, 8: 17e6, 15: 8e6, 23: 30e6}


def grch38_shaped(mbase, seed):
    """GRCh38's records scaled to ``mbase`` Mbase, as uint8 ASCII: 10 kb
    of N (scaled) at both ends of each nuclear chromosome, the arms and
    blocks above, 38 interior runs of 50 kb to 1 Mbase (scaled), and
    lower case in every other run of 100 bp to 10 kb (not scaled)."""
    rng = np.random.default_rng(seed)
    f = mbase * 1e6 / GRCH38_BASES
    interior = rng.choice(len(GRCH38) - 1, 38,
                          p=np.array(GRCH38[:-1]) / sum(GRCH38[:-1]))
    records = []
    for i, full in enumerate(GRCH38):
        n = max(1, round(full * f))
        seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
        N = np.zeros(n, bool)
        if i < len(GRCH38) - 1:  # chrM has no N
            end = round(1e4 * f)
            N[:end] = N[n - end:] = True
            arm = round(ARMS.get(i, 0) * f)
            N[end:end + arm] = True
            runs = [round(BLOCKS[i] * f)] if i in BLOCKS else []
            runs += [round(np.exp(rng.uniform(np.log(5e4), np.log(1e6))) * f)
                     for _ in range((interior == i).sum())]
            for r in runs:
                at = rng.integers(end + arm, n - end - r)
                N[at:at + r] = True
        runs = np.exp(rng.uniform(np.log(100), np.log(1e4), n // 50 + 2))
        edges = np.cumsum(runs.astype(np.int64))
        lower = np.searchsorted(edges, np.arange(n), side="right") % 2 == 1
        seq = np.where(lower, seq | 0x20, seq)
        records.append(np.where(N, np.uint8(ord("N")), seq).astype(np.uint8))
    return records


def fasta(records, width=50):
    out = []
    for name, seq in zip(NAMES, records):
        out.append(b">" + name.encode() + b"\n")
        out += [seq[i:i + width].tobytes() + b"\n"
                for i in range(0, len(seq), width)]
    return b"".join(out)


@pytest.fixture(scope="module")
def assembly(tmp_path_factory):
    records = grch38_shaped(4.2, SEED)
    path = tmp_path_factory.mktemp("assembly") / "grch38_small.fa"
    path.write_bytes(fasta(records))
    return records, str(path)


def _batches(path, cls=IngestPipeline, pack_mode=1):
    pipe = cls([path], K, ROW, ROWS, pack_mode=pack_mode)
    try:
        return list(pipe.batches())
    finally:
        pipe.close()


def _port_sketch(batches, packed):
    eng = te.SketchEngine(default_nucleotide_params(), chunk_len=ROW,
                          device="cpu")
    return eng.state_to_ref(eng.fold_batches(eng.empty_state(), batches,
                                             packed=packed))


@pytest.fixture(scope="module")
def packed_batches(assembly):
    if not ingest_available():
        pytest.skip("native ingest library unavailable")
    return _batches(assembly[1])


@pytest.fixture(scope="module")
def mash_tpu_sketch(assembly):
    eng = JaxEngine(jax_params(), chunk_len=ROW)
    state = eng.fold_batches(eng.empty_state(),
                             _batches(assembly[1], JaxIngest), ROWS,
                             packed=True)
    return eng.state_to_ref(state)


def test_the_input_has_grch38s_shapes(assembly, packed_batches):
    recs, _path = assembly
    assert len(recs) == 25
    assert K <= len(recs[-1]) < ROW  # chrM: shorter than a row
    seq = np.concatenate(recs)
    n = seq == ord("N")
    assert 0.04 < n.mean() < 0.06  # 150 of 3088 Mbase
    lower = (seq >= ord("a")).sum() / (~n).sum()
    assert 0.4 < lower < 0.6
    assert len(packed_batches) >= 20
    assert all(b.shape[0] == ROWS for b in packed_batches[:-1])
    # the validity mask of a packed row: a row wholly inside an N run
    # has none set
    masks = np.concatenate([b[:, ROW // 4:] for b in packed_batches])
    assert (~masks.any(axis=1)).sum() >= 3


@pytest.mark.parametrize("pack_mode", [0, 1])
def test_port_equals_mash_tpu(assembly, packed_batches, mash_tpu_sketch,
                              pack_mode):
    batches = (packed_batches if pack_mode
               else _batches(assembly[1], pack_mode=0))
    ref = _port_sketch(batches, packed=bool(pack_mode))
    assert len(ref.hashes) == 1000
    np.testing.assert_array_equal(ref.hashes, mash_tpu_sketch.hashes)
    np.testing.assert_array_equal(ref.counts, mash_tpu_sketch.counts)


# -- a length above 2^31 through .msh and info --------------------------------

def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    assert rc in (0, None)
    return buf.getvalue()


@pytest.fixture
def big_msh(tmp_path, monkeypatch):
    monkeypatch.setenv("MASH_TPU_TORCH_DEVICE", "cpu")
    rng = np.random.default_rng(5)
    hashes = np.unique(rng.integers(0, 2**63, 1000, dtype=np.uint64))
    ref = SketchRef(name="grch38.fa", comment="chr1 [25 seqs] [...]",
                    length=GRCH38_BASES, hashes=hashes,
                    counts=np.ones(len(hashes), np.uint32),
                    counts_sorted=True)
    path = str(tmp_path / "grch38.msh")
    capnp_msh.write_msh(path, default_nucleotide_params(), [ref])
    return path


def test_a_length_above_2_31_round_trips(big_msh):
    (ref,) = capnp_msh.read_msh(big_msh).references
    assert ref.length == GRCH38_BASES


@pytest.mark.parametrize("opts", [[], ["-t"], ["-d"], ["-H"]])
def test_info_of_a_3_gbase_sketch_equals_mash_tpu(big_msh, opts):
    got = _cli(torch_main, ["info", *opts, big_msh])
    assert got == _cli(jax_main, ["info", *opts, big_msh])
    if opts != ["-H"]:
        assert str(GRCH38_BASES) in got


# -- the stages of the benchmark's readers ------------------------------------

@pytest.fixture
def timings(monkeypatch):
    monkeypatch.setattr(profiling, "_TIMINGS_ENABLED", True)
    profiling.pop_records()
    profiling.pop_stage_totals()
    yield
    profiling.pop_records()
    profiling.pop_stage_totals()


def _parent_names(spans, name):
    return [spans[s.parent].name if s.parent >= 0 else None
            for s in spans if s.name == name]


def test_each_upload_nests_in_its_fold_batch(timings, packed_batches):
    batches = packed_batches
    eng = te.SketchEngine(default_nucleotide_params(), chunk_len=ROW,
                          device="cpu")
    eng.fold_batches(eng.empty_state(), batches[:3], packed=True)
    spans, _ = profiling.pop_records()
    assert _parent_names(spans, "transfer:upload") == ["engine:fold_batch"] * 3
    assert _parent_names(spans, "engine:fold_batch") == [
        "engine:fold_batches"] * 3


class _Event:
    """A CUDA event's stand-in: nothing to wait for."""

    def record(self, stream=None):
        pass

    def synchronize(self):
        pass


def _card_uploader(monkeypatch, slots):
    """An ``Uploader`` on its card branch, on the CPU: pinning and
    events stood in for."""
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **kw:
                        empty(*a, **kw))
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: None)
    up = transfer.Uploader("cpu", slots=slots)
    up._cuda = True
    return up


@pytest.mark.parametrize("source", ["writable", "read_only", "uint32",
                                    "strided"])
def test_the_upload_copies_into_its_slot(monkeypatch, source):
    """Every kind of array lands in the slot whole (a large batch on
    torch's threads, a read-only one by numpy), and the caller may
    reuse the array at once."""
    up = _card_uploader(monkeypatch, slots=2)
    arr = np.random.default_rng(3).integers(0, 255, (33, 4099), np.uint8)
    if source == "read_only":
        arr = np.frombuffer(arr.tobytes(), np.uint8).reshape(arr.shape)
    elif source == "uint32":
        arr = arr[:, :4096].copy().view(np.uint32)
    elif source == "strided":
        arr = arr[:, ::2]
    want = torch.from_numpy(arr.copy())
    got = up.upload(arr)
    if arr.flags.writeable:
        arr[...] = 0
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_the_slot_wait_nests_in_the_upload(timings, monkeypatch):
    """The card's branch of ``Uploader.upload`` on the CPU: a ring of
    one slot, so the second upload waits for the first's copy."""
    up = _card_uploader(monkeypatch, slots=1)
    arr = np.arange(64, dtype=np.uint8).reshape(8, 8)
    for _ in range(2):
        assert torch.equal(up.upload(arr), torch.from_numpy(arr))
    spans, _ = profiling.pop_records()
    assert _parent_names(spans, "wait:upload_slot") == ["transfer:upload"]
    assert [s.name for s in spans].count("transfer:upload") == 2


def _pinned_stand_in(monkeypatch, *arrays):
    """``Tensor.is_pinned`` stood in for on the CPU: true for any address
    inside ``arrays``, as CUDA answers for any address inside a pinned
    block."""
    spans = [(a.ctypes.data, a.ctypes.data + a.nbytes) for a in arrays]
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self, device=None:
                        any(lo <= self.data_ptr() < hi for lo, hi in spans))


@pytest.mark.parametrize("source", ["pinned", "pinned_rows",
                                    "pinned_read_only", "pinned_strided",
                                    "pageable"])
def test_the_upload_route_follows_the_memory(timings, monkeypatch, source):
    """A writable C-contiguous array in pinned memory (a batch, or its
    leading rows) goes up as it is, with nothing copied into a slot
    (``transfer:direct_bytes``); a read-only or strided view of the same
    memory and a pageable array are copied into the slot first
    (``transfer:staged_bytes``)."""
    up = _card_uploader(monkeypatch, slots=2)
    block = np.random.default_rng(5).integers(0, 255, (16, 4096), np.uint8)
    _pinned_stand_in(monkeypatch, block)
    if source == "pinned":
        arr = block
    elif source == "pinned_rows":
        arr = block[:5]
    elif source == "pinned_read_only":
        arr = block[:5].view()
        arr.flags.writeable = False
    elif source == "pinned_strided":
        arr = block[:, ::2]
    else:
        arr = block.copy()
    want = torch.from_numpy(arr.copy())
    assert torch.equal(up.upload(arr), want)
    _spans, counts = profiling.pop_records()
    totals = profiling.counter_totals(counts)
    direct = source in ("pinned", "pinned_rows")
    assert totals.get("transfer:direct_bytes", 0) == direct * arr.nbytes
    assert totals.get("transfer:staged_bytes", 0) == (not direct) * arr.nbytes
    assert up.pinned_bytes() == (not direct) * arr.nbytes


def test_a_slot_holds_a_pinned_batch_until_its_copy_is_done(monkeypatch):
    """The direct route keeps the caller's pinned array in its slot: a
    batch its holder dropped at once stays alive until the slot is next
    taken, and is let go only after the wait for its copy's event."""
    alive_at_wait = []
    batches = [np.full((4, 64), i, np.uint8) for i in range(3)]
    refs = [weakref.ref(b) for b in batches]

    class Event(_Event):
        def synchronize(self):
            alive_at_wait.append(refs[0]() is not None)

    up = _card_uploader(monkeypatch, slots=2)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    _pinned_stand_in(monkeypatch, *batches)

    def send(i):
        up.upload(batches[i])
        batches[i] = None  # the holder drops the batch at once

    send(0)
    send(1)
    assert refs[0]() is not None and refs[1]() is not None
    send(2)  # takes slot 0 again: its batch goes after the wait
    assert alive_at_wait == [True]
    assert refs[0]() is None
    assert refs[1]() is not None and refs[2]() is not None
    assert up.pinned_bytes() == 0


def test_the_settle_nests_in_the_next_fold_batch(timings, monkeypatch):
    """The card's deferred certificate on the CPU: each batch's rows are
    settled in the next batch's ``engine:settle``, the wait for their
    mask (an event stood in for) nested in it; the last batch settles in
    ``state_to_ref``."""
    init = transfer.Readback.__init__

    def with_event(self, tensor):
        init(self, tensor)
        self._event = _Event()

    monkeypatch.setattr(transfer.Readback, "__init__", with_event)
    rng = np.random.default_rng(9)
    rows = np.frombuffer(b"ACGTacgt", np.uint8)[
        rng.integers(0, 8, (6, 20 * 1024))]
    # windows in the first subrow only, fewer than s candidates: this
    # row lacks the certificate
    rows[2, 2048 + K - 1:] = ord("N")
    rows[4] = ord("N")  # no window at all
    p = default_nucleotide_params()
    p.min_hashes_per_window = 1300
    eng = te.SketchEngine(p, device="cpu")
    state = eng.fold_batches(eng.empty_state(),
                             [rows[:2], rows[2:4], rows[4:]])
    ref = eng.state_to_ref(state)
    spans, counts = profiling.pop_records()
    assert _parent_names(spans, "engine:settle") == ["engine:fold_batch"] * 2
    waits = _parent_names(spans, "wait:readback")
    assert waits == ["engine:settle", "engine:settle", "engine:state_to_ref"]
    assert profiling.counter_totals(counts)["sketch:rows_recomputed"] == 1
    # the plain reference: a full sort a row, then the merge
    want = eng.state_to_ref(sketch_ops.tree_merge(*sk.sketch_chunks_plain(
        torch.from_numpy(rows), **hash_kw(p), s=1300), s=1300))
    np.testing.assert_array_equal(ref.hashes, want.hashes)
    np.testing.assert_array_equal(ref.counts, want.counts)


def test_timings_off_add_no_stage(monkeypatch):
    monkeypatch.setattr(profiling, "_TIMINGS_ENABLED", False)
    profiling.pop_records()
    up = transfer.Uploader("cpu")
    up.upload(np.zeros((2, 8), np.uint8))
    assert profiling.pop_records() == ([], [])
