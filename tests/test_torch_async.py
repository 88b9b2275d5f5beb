"""The port's asynchronous dispatch on the CPU against mash_tpu.

The streaming paths of ``mash_tpu_torch`` queue their device work
without waiting: uploads through pinned memory (``utils.transfer``), the
sketch kernel's certificate settled one batch behind
(``ops.sketch_ops.fold_batch``), one exact-route chunk in flight
(``core.engine.sketch_records_exact``) and ``depth`` stripes in flight
(``ops.distance.stream_pair_stripes``).  None of that may change an
output.  Every case feeds numpy-seeded inputs to both packages and
requires equality:

- the deferred fold, with ``sketch_select``'s plain version standing in
  for the kernel, on rows that fail the certificate (short tail rows,
  low-complexity rows), one batch's rows settled only at
  ``state_to_ref``, batches in shuffled order, one device and two;
- the exact route (``-r -m 2``, ``-b``, ``-M``, ``-c``) with a small
  chunk, so that many chunks are in flight, against ``mash_tpu``'s
  ``.msh`` bytes and stderr; ``-c`` stops mid-chunk with the next chunk
  dispatched, and in the last chunk;
- the stripes at depth 1, 2, 3 and 5, with and without ``triangle``, a
  ``stripe_filter``, partial and full sketches, in stripe order;
- ``Uploader`` and ``Readback``, which are identities on the CPU.
"""

import contextlib
import functools
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mash_tpu.__main__ import main as jax_main
from mash_tpu.core.params import default_nucleotide_params as jax_params
from mash_tpu.ops import sketch_ops as jops
from mash_tpu.ops.distance import stream_pair_stripes as jax_stripes
from mash_tpu.ops.pallas_sketch import sketch_chunks_auto as jax_chunks
from mash_tpu_torch.__main__ import main as torch_main
from mash_tpu_torch.core import engine as te
from mash_tpu_torch.core.params import default_nucleotide_params
from mash_tpu_torch.ops import distance as td
from mash_tpu_torch.ops import sketch_kernel as sk
from mash_tpu_torch.ops import sketch_ops
from mash_tpu_torch.ops.kmers import alphabet_bytes
from mash_tpu_torch.utils.transfer import Readback, Uploader

ACGT = np.frombuffer(b"ACGT", np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")
K = 21
S_FOLD = 1300  # m = 1024 < s: a row with one full subrow fails
WIDTH = 20 * 1024  # 20460 windows a row: the kernel's route (> 8 C)


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MASH_TPU_TORCH_DEVICE", "cpu")
        yield


# -- the deferred certificate -----------------------------------------------

def _fold_rows(rng, n_rows, width=WIDTH):
    """``n_rows`` rows of random DNA, and rows that fail the certificate:
    a short tail (one subrow of valid windows, then 0x00) and a
    low-complexity row (a repeated motif: few distinct hashes, each
    many times)."""
    rows = ACGT[rng.integers(0, 4, (n_rows, width))]
    rows[1, 2048 + K - 1 :] = 0  # short tail row
    motif = ACGT[rng.integers(0, 4, 37)]
    rows[3] = np.resize(motif, width)  # low-complexity row
    rows[3, rng.integers(0, width, 40)] = ord("N")
    rows[5, : width // 2] = np.frombuffer(b"acgt", np.uint8)[
        rng.integers(0, 4, width // 2)]  # lower case: same k-mers
    return np.ascontiguousarray(rows)


def _jax_state(rows, s):
    kw = dict(alphabet=alphabet_bytes(jax_params().alphabet), k=K, seed=42,
              use64=True, noncanonical=False, preserve_case=False)
    h, c = jax_chunks(jnp.asarray(rows), **kw, s=s)
    h, c = jops.tree_merge(h, c, s=s)
    n = int((np.asarray(c) > 0).sum())
    return (np.asarray(h)[:n].astype(np.uint64),
            np.asarray(c)[:n].astype(np.uint32))


@pytest.fixture
def one_thread():
    """One torch intra-op thread for the test: on cores that other test
    workers hold, each of many small plain-torch ops otherwise waits for
    a whole team of threads to be scheduled."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def deferred(monkeypatch):
    """Counts the rows that the deferred certificate (on the CPU, on
    ``sketch_select``'s plain version) recomputes."""
    seen = {"recomputed": 0}
    states = sketch_ops.Uncertified.states

    def counted(self):
        got = states(self)
        if got is not None:
            seen["recomputed"] += int(got[0].numel())
        return got

    monkeypatch.setattr(sketch_ops.Uncertified, "states", counted)
    return seen


def _engine(n_devices=1):
    p = default_nucleotide_params()
    p.min_hashes_per_window = S_FOLD
    eng = te.SketchEngine(p, device="cpu")
    eng.devices = [torch.device("cpu")] * n_devices
    return eng


@pytest.mark.parametrize("order", ["in_order", "shuffled"])
@pytest.mark.parametrize("n_devices", [1, 2], ids=["one", "two_devices"])
def test_deferred_fold_equals_mash_tpu(deferred, order, n_devices):
    rng = np.random.default_rng(11)
    rows = _fold_rows(rng, 8)
    batches = [rows[i : i + 2] for i in range(0, 8, 2)]
    if order == "shuffled":
        batches = [batches[i] for i in rng.permutation(len(batches))]
    eng = _engine(n_devices)
    state = eng.fold_batches(eng.empty_state(), iter(batches))
    ref = eng.state_to_ref(state)
    want_h, want_c = _jax_state(rows, S_FOLD)
    np.testing.assert_array_equal(ref.hashes, want_h)
    np.testing.assert_array_equal(ref.counts, want_c)
    assert deferred["recomputed"] == 2  # the tail row and the repeat row


def test_pending_batch_settles_at_state_to_ref(deferred):
    """The last batch's failing rows wait in the state until it is read;
    folding more batches into a state that was read counts nothing
    twice."""
    rng = np.random.default_rng(12)
    rows = _fold_rows(rng, 6)
    eng = _engine()
    state = eng.fold_batches(eng.empty_state(), [rows[:2], rows[2:4]])
    assert isinstance(state, sketch_ops.PendingState)
    assert not state.settled() and deferred["recomputed"] == 1
    ref = eng.state_to_ref(state)  # settles the repeat row of rows[2:4]
    assert state.settled() and deferred["recomputed"] == 2
    want_h, want_c = _jax_state(rows[:4], S_FOLD)
    np.testing.assert_array_equal(ref.hashes, want_h)
    np.testing.assert_array_equal(ref.counts, want_c)
    # the estimates read the settled state; a further fold starts from it
    assert eng.estimate_set_size(state) > 0
    more = eng.fold_batches(state, [rows[4:]])
    ref = eng.state_to_ref(more)
    want_h, want_c = _jax_state(rows, S_FOLD)
    np.testing.assert_array_equal(ref.hashes, want_h)
    np.testing.assert_array_equal(ref.counts, want_c)
    assert deferred["recomputed"] == 2


def test_fused_equals_deferred_settled():
    """``sketch_chunks_fused`` (settled at once) equals the deferred
    states with the failing rows merged in, row by row."""
    rng = np.random.default_rng(13)
    rows = torch.from_numpy(_fold_rows(rng, 6))
    kw = dict(alphabet=alphabet_bytes(default_nucleotide_params().alphabet),
              k=K, seed=42, use64=True, noncanonical=False,
              preserve_case=False, s=S_FOLD)
    H, C = sk.sketch_chunks_fused(rows, **kw)
    Hd, Cd, pending = sk.sketch_chunks_deferred(rows, **kw)
    bad = pending.mask.numpy()
    assert bad.tolist() == [False, True, False, True, False, False]
    assert (Cd[torch.from_numpy(bad)] == 0).all()
    sel, h, c = pending.states()
    Hd[sel], Cd[sel] = h, c
    assert torch.equal(H, Hd) and torch.equal(C, Cd)
    Hp, Cp = sk.sketch_chunks_plain(rows, **kw)
    assert torch.equal(H, Hp) and torch.equal(C, Cp)


@pytest.mark.usefixtures("one_thread")
def test_screen_fold_deferred_equals_mash_tpu(deferred):
    """The screen fold's cardinality state: the sketch kernel's
    certificate (its plain version) settled a batch behind, equal to
    ``mash_tpu``'s ``sketch_chunk_batch``."""
    from mash_tpu.ops.kmers import hash_chunk as jax_hash
    from mash_tpu_torch.ops import screen_ops

    rng = np.random.default_rng(14)
    # the kernel's route needs more than 8 subrows; m = 256 < s
    rows = _fold_rows(rng, 6, width=40 * 1024)
    p = default_nucleotide_params()
    p.min_hashes_per_window = 400
    s = 400
    db = np.unique(rng.integers(0, 2**63, 100, dtype=np.uint64))
    _fold, fold_rows, counts, _fin = screen_ops.make_screen_fold(
        p, db, s, device="cpu")
    state = sketch_ops.empty_state(s)
    for b in (rows[:3], rows[3:]):
        counts, state = fold_rows(counts, state, torch.from_numpy(b))
    assert isinstance(state, sketch_ops.PendingState)
    assert deferred["recomputed"] == 1  # the tail row, a batch behind
    kw = dict(alphabet=alphabet_bytes(jax_params().alphabet), k=K, seed=42,
              use64=True, noncanonical=False, preserve_case=False)
    jh, jv = jax_hash(jnp.asarray(rows), **kw)
    wh, wc = jops.tree_merge(*jops.sketch_chunk_batch(jh, jv, s=s), s=s)
    h, c = state
    assert deferred["recomputed"] == 2  # and the repeat row, when read
    np.testing.assert_array_equal(h.numpy(), np.asarray(wh))
    np.testing.assert_array_equal(c.numpy(), np.asarray(wc))


# -- the exact route, a chunk in flight ---------------------------------------

def _write_reads(rng, path, genome, n, tag, length=150):
    with open(path, "wb") as f:
        for i in range(n):
            p = int(rng.integers(0, len(genome) - length))
            seq = genome[p : p + length].copy()
            hit = rng.random(length) < 0.002
            seq[hit] = ACGT[rng.integers(0, 4, int(hit.sum()))]
            raw = seq.tobytes()
            if i % 2:
                raw = raw.translate(COMP)[::-1]
            f.write(b"@%s%d\n%s\n+\n%s\n" % (tag, i, raw, b"I" * length))


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("async_reads")
    rng = np.random.default_rng(43)
    genome = ACGT[rng.integers(0, 4, 8000)]
    _write_reads(rng, d / "r1.fq", genome, 300, b"a")
    _write_reads(rng, d / "r2.fq", genome, 200, b"b")
    return d


# 1100-byte chunks hold seven 150-base reads (with their separators)
CHUNK = 1100
COV = "3"  # -c 3 stops r1.fq's 300 reads at read 193, mid-chunk


@pytest.fixture
def small_chunks(monkeypatch):
    """The port's engines cut 1100-byte chunks; records which records
    each dispatched chunk holds."""
    from mash_tpu_torch.core import loader

    chunks = []
    dispatch = te.SketchEngine.hash_bytes_async

    def counted(self, data):
        chunks.append(data.count(b"\x00") + 1)
        return dispatch(self, data)

    monkeypatch.setattr(loader, "SketchEngine",
                        functools.partial(te.SketchEngine, chunk_len=CHUNK))
    monkeypatch.setattr(te.SketchEngine, "hash_bytes_async", counted)
    return chunks


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    assert rc in (0, None), (argv, err.getvalue())
    return err.getvalue()


def _sketch_both(d, opts, files, tag):
    got = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        prefix = str(d / ("%s_%s" % (tag, name)))
        err = _run(main, ["sketch", *opts, "-o", prefix, *files])
        with open(prefix + ".msh", "rb") as f:
            got[name] = (f.read(), err.replace(prefix, "OUT"))
    assert got["jax"] == got["torch"], opts
    return got["torch"][1]


@pytest.mark.parametrize(
    "opts", [["-r", "-m", "2"], ["-b", "1M"], ["-M"],
             ["-r", "-k", "16", "-m", "2", "-M"]],
    ids=["m2", "b1M", "M", "k16_m2_M"])
def test_exact_route_chunks_in_flight(reads, small_chunks, opts):
    _sketch_both(reads, opts, [str(reads / "r1.fq"), str(reads / "r2.fq")],
                 "_".join(opts).replace("-", ""))
    assert len(small_chunks) >= 70  # 500 reads, seven a chunk


def _stop_chunk(chunks, used):
    """(index of the chunk whose drain stopped the stream, whether the
    stop fell on a record inside it rather than its first)."""
    first = 0
    for i, n in enumerate(chunks):
        if used < first + n:
            return i, used > first
        first += n
    raise AssertionError("the stream did not stop")


def _used(err):
    return int(err.split("Reads used:")[1].split()[0])


@pytest.mark.parametrize("cut", [False, True],
                         ids=["next_in_flight", "last_chunk"])
def test_exact_route_target_coverage_stop(reads, small_chunks, cut,
                                          tmp_path):
    """``-c`` stops while chunk i drains: mid-chunk with chunk i+1
    dispatched (dropped unread), and, on a file cut two reads after
    that stop, in the last chunk with none in flight."""
    src = reads / "r1.fq"
    used = _used(_sketch_both(reads, ["-c", COV], [str(src)], "c_full"))
    assert used < 300
    if cut:
        lines = src.read_bytes().split(b"\n")
        src = tmp_path / "cut.fq"
        src.write_bytes(b"\n".join(lines[: 4 * (used + 2)]) + b"\n")
        small_chunks.clear()
        assert _used(_sketch_both(reads, ["-c", COV], [str(src)],
                                  "c_cut")) == used
    stop, mid = _stop_chunk(small_chunks, used)
    assert mid, (used, small_chunks)
    # chunks dispatched: up to the stop's, and the next unless none is left
    assert len(small_chunks) == stop + (1 if cut else 2)


# -- the stripes, depth in flight -------------------------------------------

S = 64


def _sketches(rng, n, full):
    pool = np.unique(rng.integers(0, 2**64 - 1, 4 * S, dtype=np.uint64))
    out = []
    for i in range(n):
        size = S if full else int(rng.integers(10, S + 1))
        h = rng.choice(pool, size=2 * S, replace=False)
        priv = rng.random(h.size) < 0.3
        h[priv] = rng.integers(0, 2**64 - 1, int(priv.sum()), dtype=np.uint64)
        out.append(np.unique(h)[:size])
    return out


@pytest.mark.parametrize("depth", [1, 2, 3, 5])
@pytest.mark.parametrize("triangle", [False, True], ids=["rect", "triangle"])
@pytest.mark.parametrize("full", [False, True], ids=["partial", "full"])
def test_stripes_depth_equal_mash_tpu(depth, triangle, full):
    rng = np.random.default_rng(100 + 2 * full + triangle)
    Hq, Nq = td.pad_sketches(_sketches(rng, 37, full), S)
    Hr, Nr = (Hq, Nq) if triangle else td.pad_sketches(
        _sketches(rng, 29, full), S)
    kw = dict(row_block=8, tile_r=12, triangle=triangle)
    got = list(td.stream_pair_stripes(Hq, Nq, Hr, Nr, S, "cpu", depth=depth,
                                      **kw))
    want = list(jax_stripes(Hq, Nq, Hr, Nr, S, **kw))
    assert [i0 for i0, _ in got] == list(range(0, 37, 8))
    assert [i0 for i0, _ in got] == [i0 for i0, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == np.uint32
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("depth", [1, 3])
def test_stripes_depth_with_filter(depth):
    """Only the accepted stripes are computed, in stripe order."""
    rng = np.random.default_rng(7)
    H, N = td.pad_sketches(_sketches(rng, 50, False), S)

    def odd(i0, row_block):
        return (i0 // row_block) % 2 == 1

    got = list(td.stream_pair_stripes(H, N, H, N, S, "cpu", row_block=8,
                                      tile_r=12, triangle=True,
                                      stripe_filter=odd, depth=depth))
    want = list(jax_stripes(H, N, H, N, S, row_block=8, tile_r=12,
                            triangle=True, stripe_filter=odd))
    assert [i0 for i0, _ in got] == [8, 24, 40]
    assert [i0 for i0, _ in got] == [i0 for i0, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


# -- transfers ------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.int64, np.bool_])
def test_uploader_is_identity_on_cpu(dtype):
    rng = np.random.default_rng(3)
    up = Uploader("cpu", slots=2)
    for rows in (3, 5, 2):
        arr = rng.integers(0, 2, (rows, 7)).astype(dtype)
        t = up.upload(arr)
        assert t.device.type == "cpu" and tuple(t.shape) == arr.shape
        np.testing.assert_array_equal(t.numpy(), arr)
        np.testing.assert_array_equal(Readback(t).numpy(), arr)
    assert up.pinned_bytes() == 0
    with pytest.raises(ValueError):
        Uploader("cpu", slots=0)


@pytest.mark.parametrize("source", ["writable", "read_only", "strided"])
def test_uploader_on_cpu_takes_neither_card_route(monkeypatch, source):
    """On the CPU the upload stays the identity (a writable C-contiguous
    array comes back as the same memory, any other as a copy), and
    neither route's byte counter moves."""
    from mash_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_TIMINGS_ENABLED", True)
    profiling.pop_records()
    arr = np.random.default_rng(4).integers(0, 256, (6, 64), np.uint8)
    if source == "read_only":
        arr = np.frombuffer(arr.tobytes(), np.uint8).reshape(arr.shape)
    elif source == "strided":
        arr = arr[:, ::2]
    t = Uploader("cpu").upload(arr)
    np.testing.assert_array_equal(t.numpy(), arr)
    assert np.shares_memory(t.numpy(), arr) == (source == "writable")
    _spans, counts = profiling.pop_records()
    profiling.pop_stage_totals()
    totals = profiling.counter_totals(counts)
    assert totals.get("transfer:direct_bytes", 0) == 0
    assert totals.get("transfer:staged_bytes", 0) == 0
