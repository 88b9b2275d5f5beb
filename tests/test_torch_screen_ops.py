"""The port's screen modules against mash_tpu's on the same inputs.

Inputs are made from numpy seeds and handed to both packages; every
output is an integer (or a byte string), so the tolerance is exact
equality.  ``mash_tpu``'s big-DB counter runs its Pallas kernel in
interpret mode with the small tiles of ``tests/test_bigdb_screen.py``.
Counts seeded at the limits hold the port's overflow rule against
``mash_tpu``'s: uint32 counts that wrap for a DB of at most ``BIG_DB_MIN``
hashes, int32 counts that saturate (``_accum``) above it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mash_tpu.core.params import default_nucleotide_params as j_params
from mash_tpu.ops import screen_ops as jso
from mash_tpu.ops import sketch_ops as jsk
from mash_tpu_torch.convert import (
    db_table_from_numpy,
    params_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from mash_tpu_torch.ops import screen_kernel as tsk
from mash_tpu_torch.ops import screen_ops as tso
from mash_tpu_torch.ops import sketch_ops as tsketch

SENT = np.uint64(0xFFFFFFFFFFFFFFFF)
IMAX = np.iinfo(np.int32).max
UMAX = np.iinfo(np.uint32).max


def _t64(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


def _db(rng, H, sentinel=False, lo=0, hi=2**63):
    db = np.unique(rng.integers(lo, hi, size=H, dtype=np.int64)
                   .astype(np.uint64))
    if sentinel:
        db = np.unique(np.concatenate([db, [SENT]]))
    return db


def _chunk(rng, db, n, sentinel=False, p_valid=0.8):
    """n random hashes, a quarter planted from the DB (with repeats)."""
    h = rng.integers(0, 2**63, size=n, dtype=np.int64).astype(np.uint64)
    h[: n // 4] = db[rng.choice(len(db), size=n // 4)]
    if sentinel:
        h[n // 4 : n // 4 + 7] = SENT
    rng.shuffle(h)
    return h, rng.random(n) < p_valid


@pytest.mark.parametrize("seed", [0, 1])
def test_build_db_table(seed):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 2**64 - 1, 50, dtype=np.uint64)
    lists = [np.unique(np.concatenate(
        [rng.choice(shared, 20), rng.integers(0, 2**64 - 1, 30 + i,
                                              dtype=np.uint64)]))
        for i in range(6)]
    lists.append(np.array([SENT], np.uint64))
    for a, b in zip(tso.build_db_table(lists), jso.build_db_table(lists)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tso.build_db_table([]), jso.build_db_table([])):
        np.testing.assert_array_equal(a, b)


def _csr(rng, n_refs=7, n_hashes=400):
    seg_len = rng.integers(1, 5, size=n_hashes)
    seg_starts = np.concatenate([[0], np.cumsum(seg_len)])
    ref_ids = np.concatenate(
        [rng.choice(n_refs, size=m, replace=False) for m in seg_len]
    ).astype(np.int64)
    counts = rng.integers(0, 4, size=n_hashes).astype(np.int64)
    return counts, seg_starts, ref_ids


def _same_tally(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("min_cov", [1, 2])
def test_tally_shared(min_cov):
    rng = np.random.default_rng(min_cov)
    counts, seg_starts, ref_ids = _csr(rng)
    _same_tally(
        tso.tally_shared(counts, seg_starts, ref_ids, 7, min_cov),
        jso.tally_shared(counts, seg_starts, ref_ids, 7, min_cov),
    )


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("min_cov", [1, 2])
def test_winner_takes_all(seed, min_cov):
    """Seeds and min_cov of ``tests/test_screen_wta.py``, with its
    quantized score and length ties."""
    rng = np.random.default_rng(seed)
    counts, seg_starts, ref_ids = _csr(rng)
    scores = rng.integers(0, 4, size=7).astype(np.float64) / 4.0
    lengths = rng.integers(1, 4, size=7).astype(np.int64) * 1000
    _same_tally(
        tso.winner_takes_all(counts, seg_starts, ref_ids, scores, lengths,
                             min_cov),
        jso.winner_takes_all(counts, seg_starts, ref_ids, scores, lengths,
                             min_cov),
    )


@pytest.mark.parametrize("n", [0, 2, 99, 1000, 3001])
def test_translate_frames(n):
    rng = np.random.default_rng(n)
    chunk = np.frombuffer(b"ACGTACGTACGTNRY\x00", np.uint8)[
        rng.integers(0, 16, n)]
    got = tso.translate_frames(chunk)
    want = jso.translate_frames(chunk)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(tso._codon_lut(), jso._codon_lut())


def test_accum_int32_wrap_boundary():
    """``mash_tpu``'s saturating ``_accum`` against the port's big-DB
    rule applied to the exact totals."""
    counts = np.array([IMAX - 1, IMAX - 3, 5, 0, IMAX, IMAX], np.int32)
    add = np.array([3, 1, 1, 0, 0, 7], np.int32)
    want = np.asarray(jso._accum(jnp.asarray(counts), jnp.asarray(add)))
    totals = torch.from_numpy(counts.astype(np.int64) + add)
    got = tso.counts_from_totals(totals, big_db=True)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want.astype(np.uint32))
    assert want[0] == IMAX and want[5] == IMAX


def _seeded(rng, n, top):
    """n random counts below 50, the first three just below ``top``."""
    c = rng.integers(0, 50, n).astype(np.int64)
    c[:3] = top - np.arange(1, 4)
    return c


@pytest.mark.parametrize("H", [2000, 40000])
@pytest.mark.parametrize("sentinel", [False, True], ids=["plain", "sentinel"])
def test_count_db_occurrences(H, sentinel):
    """``mash_tpu``'s compare-reduce (H = 2 000) and DB-side search
    (H = 40 000) tiers with uint32 counts seeded just below 2^32, which
    wrap, against the port's totals and small-DB rule."""
    rng = np.random.default_rng(H + sentinel)
    db = _db(rng, H, sentinel)
    h, v = _chunk(rng, db, 4096, sentinel)
    h[:64] = np.repeat(db[:3], [30, 20, 14])  # past the top on the way
    v[:64] = True
    c0 = _seeded(rng, len(db) + 1, 2**32)
    want = np.asarray(jso.count_db_occurrences(
        jnp.asarray(h), jnp.asarray(v), jnp.asarray(db),
        jnp.asarray(c0.astype(np.uint32))))
    got = tso.count_db_occurrences(_t64(h), torch.from_numpy(v), _t64(db),
                                   torch.from_numpy(c0))
    assert got.dtype == torch.int64 and int(got[0]) > UMAX
    np.testing.assert_array_equal(
        tso.counts_from_totals(got[: len(db)], big_db=False), want[:-1])
    assert want[0] < 100  # wrapped


@pytest.mark.parametrize("H", [tso.BIG_DB_MIN, tso.BIG_DB_MIN + 1],
                         ids=["at_big_db_min", "above_big_db_min"])
def test_counter_overflow_rule_by_db_size(H):
    """At ``BIG_DB_MIN`` DB hashes the counts wrap at 2^32 as ``mash_tpu``'s
    uint32 counts do; one more and they saturate at 2^31-1 as its int32
    big-DB counts do (``count_db_occurrences`` with int32 counts goes
    through the same ``_accum``)."""
    rng = np.random.default_rng(H)
    db = np.unique(rng.integers(0, 2**64 - 1, H + 64, dtype=np.uint64))[:H]
    assert len(db) == H
    h, v = _chunk(rng, db, 4096)
    h[:64] = np.repeat(db[:3], [30, 20, 14])
    v[:64] = True
    big = H > tso.BIG_DB_MIN
    c0 = _seeded(rng, H + 1, IMAX + 1 if big else 2**32)
    dtype = np.int32 if big else np.uint32
    want = np.asarray(jso.count_db_occurrences(
        jnp.asarray(h), jnp.asarray(v), jnp.asarray(db),
        jnp.asarray(c0.astype(dtype))))[:-1].astype(np.uint32)
    counter = tso.ScreenCounter(_t64(db), torch.from_numpy(c0[:H]))
    counter.add(_t64(h), torch.from_numpy(v))
    got = counter.finalize()
    np.testing.assert_array_equal(got, want)
    assert got[0] == IMAX if big else got[0] < 100  # saturated / wrapped


@pytest.mark.parametrize("sentinel", [False, True], ids=["plain", "sentinel"])
def test_screen_counter_wraps_as_plain_fold(sentinel):
    """``mash_tpu``'s plain fold (the one-device tier of a small DB) with
    its uint32 ``counts0`` seeded just below 2^32, against a seeded
    :class:`ScreenCounter` fed by the port's ``hash_chunk``."""
    from mash_tpu_torch.ops.kmers import alphabet_bytes, hash_chunk

    rng = np.random.default_rng(31 + sentinel)
    jp = j_params(21, 200)
    tp = params_from_numpy(jp)
    seq = np.frombuffer(b"ACGTACGTacgtN", np.uint8)[rng.integers(0, 13, 6000)]
    th, tv = hash_chunk(torch.from_numpy(seq.copy()),
                        alphabet=alphabet_bytes(tp.alphabet),
                        k=tp.kmer_size, seed=tp.seed, use64=tp.use64,
                        noncanonical=tp.noncanonical,
                        preserve_case=tp.preserve_case)
    occurring = np.unique(th[tv].numpy().view(np.uint64))
    db = np.unique(np.concatenate(
        [occurring[:300], rng.integers(0, 2**64 - 1, 500, dtype=np.uint64)]
        + ([[SENT]] if sentinel else [])))
    c0 = _seeded(rng, len(db) + 1, 2**32)
    c0[-2] = 2**32 - 1  # the sentinel's or the last hash's count
    fold = jso.make_screen_fold(jp, jnp.asarray(db), 200)
    jc, _ = fold(jnp.asarray(c0.astype(np.uint32)), jsk.empty_state(200),
                 jnp.asarray(seq))
    counter = tso.ScreenCounter(_t64(db), torch.from_numpy(c0[:-1]))
    counter.add(th, tv)
    np.testing.assert_array_equal(counter.finalize(), np.asarray(jc)[:-1])


def _tpu_counter(db, chunks, wblk, rw):
    counter = jso.BigDBCounter(j_params(), db, s=100, chunk_len=1 << 12,
                               d_tile=256, wblk=wblk, rw=rw)
    for h, v in chunks:
        counter.add(jnp.asarray(h), jnp.asarray(v))
    return counter.finalize()


def _port_counter(db, chunks):
    dbt, _, _ = db_table_from_numpy(db, np.zeros(len(db) + 1), np.zeros(0))
    counter = tso.ScreenCounter(dbt)
    for h, v in chunks:
        counter.add(_t64(h), torch.from_numpy(v))
    return counter.finalize()


@pytest.mark.parametrize("sentinel", [False, True], ids=["plain", "sentinel"])
def test_screen_counter_matches_bigdb_counter(sentinel):
    """Chunks of two lengths, each counted as it comes."""
    rng = np.random.default_rng(23)
    db = _db(rng, 2000, sentinel)
    chunks = [_chunk(rng, db, 4096 if i < 3 else 2048, sentinel)
              for i in range(5)]
    want = _tpu_counter(db, chunks, 4, 4)
    got = _port_counter(db, chunks)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_screen_counter_skewed_stream():
    """The input of ``test_bigdb_counter_certificate_fallback``: every
    hash inside a tiny DB range.  The TPU counter needs its exact
    fallback tier; the port just counts."""
    rng = np.random.default_rng(5)
    db = _db(rng, 1024, hi=1000)
    h = rng.integers(0, 1000, size=1 << 12, dtype=np.int64).astype(np.uint64)
    chunks = [(h, np.ones(1 << 12, dtype=bool))]
    want = _tpu_counter(db, chunks, 2, 2)
    np.testing.assert_array_equal(_port_counter(db, chunks), want)


def test_screen_count_plain_edges():
    """The kernel's plain version: empty and all-invalid batches, valid
    EMPTY lanes, a DB hash of 2^64-1 (left for the caller), int64 totals
    past 2^32."""
    table = tsk.build_table(_t64(np.array([3, 9, 2**63, SENT], np.uint64)))
    # on the CPU the count searches the DB: no slot is laid out
    assert table.bits == 3 and table.keys.numel() == table.fp.numel() == 0
    totals = torch.tensor([0, 2**33, 7, 0], dtype=torch.int64)
    none = torch.zeros(0, dtype=torch.int64)
    tsk.screen_count(none, none.bool(), table, totals)
    h = _t64(np.array([9, 9, 9, 3, 2**63, SENT, SENT, 4], np.uint64))
    tsk.screen_count(h, torch.zeros(8, dtype=torch.bool), table, totals)
    assert totals.tolist() == [0, 2**33, 7, 0]
    tsk.screen_count(h, torch.ones(8, dtype=torch.bool), table, totals)
    assert totals.tolist() == [1, 2**33 + 3, 8, 0]
    with pytest.raises(ValueError):
        tsk.screen_count(h, torch.ones(8, dtype=torch.bool), table,
                         totals.int())
    with pytest.raises(ValueError):
        tsk.screen_count(h, torch.ones(7, dtype=torch.bool), table, totals)


def _probe_all(table, keys):
    """DB index of each key by linear probing of ``table`` (-1 if absent),
    one key at a time."""
    S = 1 << table.bits
    slots = tsk.home_slots(_t64(keys), table.bits).tolist()
    tk, ti = table.keys.tolist(), table.index.tolist()
    out = []
    for key, slot in zip(keys.view(np.int64).tolist(), slots):
        while tk[slot] != key and tk[slot] != -1:
            slot = (slot + 1) % S
        out.append(ti[slot] if tk[slot] == key else -1)
    return out


@pytest.mark.parametrize("case", ["one", "two", "random", "sentinel",
                                  "bits32", "small_ints", "only_sentinel"])
def test_build_table_plain(case):
    """Every DB hash but 2^64-1 is found by linear probing from its home
    slot; the occupied slots are those of one-at-a-time inserts (linear
    probing fills the same slots in any order); absent keys miss."""
    rng = np.random.default_rng(len(case))
    db = {"one": np.array([5], np.uint64),
          "two": np.array([5, SENT], np.uint64),
          "random": _db(rng, 3000),
          "sentinel": _db(rng, 1500, sentinel=True),
          "bits32": _db(rng, 2500, hi=2**32),
          "small_ints": np.arange(1000, dtype=np.uint64),
          "only_sentinel": np.array([SENT], np.uint64)}[case]
    table = tsk.build_table_plain(_t64(db))
    S = 1 << table.bits
    assert S >= 2 * len(db) and S < 4 * max(1, len(db))
    real = db != SENT
    want = np.where(real, np.arange(len(db)), -1)
    assert _probe_all(table, db) == want.tolist()
    occ, by_index = tsk.table_contents(table)
    assert torch.equal(by_index, _t64(db))
    # one key at a time, in DB order
    seq = np.full(S, False)
    for slot in tsk.home_slots(_t64(db[real]), table.bits).tolist():
        while seq[slot]:
            slot = (slot + 1) % S
        seq[slot] = True
    np.testing.assert_array_equal(occ.numpy(), seq)
    absent = rng.integers(0, 2**64 - 1, 200, dtype=np.uint64)
    absent = absent[~np.isin(absent, db)]
    assert _probe_all(table, absent) == [-1] * len(absent)


def test_make_screen_fold_matches_mash_tpu():
    """The whole fold (hash, count, cardinality state) over record-path
    chunks and a fold_rows batch, against ``mash_tpu``'s plain fold."""
    rng = np.random.default_rng(7)
    jp = j_params(21, 200)
    tp = params_from_numpy(jp)
    seq = np.frombuffer(b"ACGTACGTacgtN\x00", np.uint8)[
        rng.integers(0, 14, 3 * 5000)].reshape(3, 5000)
    # DB: hashes that occur (the sequence's bottom-s) plus random ones
    jfold0 = jso.make_screen_fold(jp, jnp.zeros(0, jnp.uint64), 200)
    _c, st = jfold0(jnp.zeros(1, jnp.uint32), jsk.empty_state(200),
                    jnp.asarray(seq[0]))
    occurring = np.asarray(st[0])[np.asarray(st[1]) > 0]
    db = np.unique(np.concatenate(
        [occurring, rng.integers(0, 2**64 - 1, 3000, dtype=np.uint64)]))

    jfold = jso.make_screen_fold(jp, jnp.asarray(db), 200)
    jc, jst = jnp.zeros(len(db) + 1, jnp.uint32), jsk.empty_state(200)
    jc, jst = jfold(jc, jst, jnp.asarray(seq[0]))
    jc, jst = jfold.fold_rows(jc, jst, jnp.asarray(seq[1:]))

    fold, fold_rows, tc, finalize = tso.make_screen_fold(tp, db, 200, "cpu")
    tst = tsketch.empty_state(200)
    tc, tst = fold(tc, tst, torch.from_numpy(seq[0].copy()))
    tc, tst = fold_rows(tc, tst, torch.from_numpy(seq[1:].copy()))

    np.testing.assert_array_equal(finalize(tc), np.asarray(jc)[:-1])
    assert np.asarray(jc)[:-1].sum() > 0
    for a, b in zip(state_to_numpy(tst), jst):
        np.testing.assert_array_equal(a, np.asarray(b))


K1_WIDTH = 20 * 1024  # more than 8 x 2048 windows a row: K1's route


def _pack_reads(reads, k, width):
    """Reads packed into zero-padded ``[rows, width]`` uint8 rows as a
    part's ingest rows hold them: 0x00 between reads, k-1 bytes shared
    by consecutive rows, the last row short."""
    from mash_tpu_torch.core.engine import chunk_stream

    rows = list(chunk_stream(reads, k, width))
    out = np.zeros((len(rows), width), np.uint8)
    for i, (chunk, used) in enumerate(rows):
        out[i, :used] = np.frombuffer(chunk, np.uint8)[:used]
    return out


@pytest.fixture
def one_thread():
    """One torch intra-op thread for the test: on cores that other test
    workers hold, each of many small plain-torch ops otherwise waits for
    a whole team of threads to be scheduled."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read_batches(rng, k, width):
    """Two ``[2, width]`` batches of 150 bp reads of a 4 kb phage-sized
    genome at deep coverage: the first ends with the part's short last
    row, the second starts with a row of reads of a tandem repeat of a
    171 bp unit (low complexity: fewer than s distinct hashes, each many
    times)."""
    genome = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 4000)]
    unit = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 171)]
    repeat = np.resize(unit, 30_000)

    def reads(seq, n):
        return [seq[p : p + 150].tobytes()
                for p in rng.integers(0, len(seq) - 150, n)]

    part = _pack_reads(reads(genome, 200), k, width)
    low = _pack_reads(reads(repeat, 135), k, width)
    more = _pack_reads(reads(genome, 135), k, width)
    assert part.shape[0] == 2 and not part[-1, width // 2 :].any()
    assert low.shape[0] == more.shape[0] == 1
    return [part, np.concatenate([low, more])]


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("k", [21, 16], ids=["k21_64bit", "k16_32bit"])
def test_screen_fold_rows_k1_route_matches_mash_tpu(monkeypatch, k):
    """``fold_rows`` through the sketch kernel's route (K1 and K6's
    candidate fold, as their plain versions on the CPU) settles to
    ``mash_tpu``'s state, with its counts; the low-complexity row lacks
    the certificate, is recomputed a batch behind, and holds hashes of
    the final state."""
    from mash_tpu_torch.ops.kmers import alphabet_bytes, hash_chunk
    from mash_tpu_torch.utils import profiling

    rng = np.random.default_rng(40 + k)
    s = 200
    jp = j_params(k, s)
    tp = params_from_numpy(jp)
    assert tp.use64 == (k > 16)
    batches = _read_batches(rng, k, K1_WIDTH)

    def distinct(rows):
        h, v = hash_chunk(torch.from_numpy(rows),
                          alphabet=alphabet_bytes(tp.alphabet), k=k,
                          seed=tp.seed, use64=tp.use64,
                          noncanonical=tp.noncanonical,
                          preserve_case=tp.preserve_case)
        return np.unique(h[v].numpy().view(np.uint64))

    in_part = distinct(np.concatenate([batches[0], batches[1][1:]]))
    in_low = distinct(batches[1][:1])
    assert len(in_low) < s
    db = np.unique(np.concatenate(
        [rng.choice(in_part, 300, replace=False), in_low[:20],
         rng.integers(0, 2**32 - 1, 500, dtype=np.uint64)]))

    jfold = jso.make_screen_fold(jp, jnp.asarray(db), s)
    jc, jst = jnp.zeros(len(db) + 1, jnp.uint32), jsk.empty_state(s)
    for b in batches:
        jc, jst = jfold.fold_rows(jc, jst, jnp.asarray(b))

    monkeypatch.setattr(profiling, "_TIMINGS_ENABLED", True)
    profiling.pop_records()
    _fold, fold_rows, tc, finalize = tso.make_screen_fold(tp, db, s, "cpu")
    state = tsketch.empty_state(s)
    for b in batches:
        tc, state = fold_rows(tc, state, torch.from_numpy(b))
    counts = finalize(tc)
    assert isinstance(state, tsketch.PendingState)
    got = state_to_numpy(state)  # settles the last batch
    _spans, cnt = profiling.pop_records()
    totals = profiling.counter_totals(cnt)
    assert totals["sketch:rows_folded"] == sum(len(b) for b in batches)
    assert totals["sketch:rows_recomputed"] == 1  # the low-complexity row

    want_counts = np.asarray(jc)[:-1]
    assert want_counts.sum() > 0
    np.testing.assert_array_equal(counts, want_counts)
    want = [np.asarray(a) for a in jst]
    kept = want[0][want[1] > 0]
    assert len(kept) == s
    assert np.isin(kept, np.setdiff1d(in_low, in_part)).any()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_convert_db_table_roundtrip():
    db, seg, ids = jso.build_db_table(
        [np.array([5, 2**64 - 1], np.uint64), np.array([5, 7], np.uint64)])
    dbt, segt, idst = db_table_from_numpy(db, seg, ids)
    assert (dbt.dtype, segt.dtype, idst.dtype) == (
        torch.int64, torch.int64, torch.int32)
    np.testing.assert_array_equal(dbt.numpy().view(np.uint64), db)
    np.testing.assert_array_equal(segt.numpy(), seg)
    np.testing.assert_array_equal(idst.numpy(), ids)
    c = tso.counts_from_totals(torch.tensor([0, IMAX, 2**32 + 5]), False)
    assert c.dtype == np.uint32 and c.tolist() == [0, IMAX, 5]
    h, c = state_from_numpy(db, np.ones(3))
    assert h.dtype == torch.int64
