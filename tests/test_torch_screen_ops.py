"""The port's screen modules against mash_tpu's on the same inputs.

Inputs are made from numpy seeds and handed to both packages; every
output is an integer (or a byte string), so the tolerance is exact
equality.  ``mash_tpu``'s big-DB counter runs its Pallas kernel in
interpret mode with the small tiles of ``tests/test_bigdb_screen.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mash_tpu.core.params import default_nucleotide_params as j_params
from mash_tpu.ops import screen_ops as jso
from mash_tpu.ops import sketch_ops as jsk
from mash_tpu_torch.convert import (
    counts_to_numpy,
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
    counts = np.array([IMAX - 1, IMAX - 3, 5, 0, IMAX, IMAX], np.int32)
    add = np.array([3, 1, 1, 0, 0, 7], np.int32)
    want = np.asarray(jso._accum(jnp.asarray(counts), jnp.asarray(add)))
    got = tso._accum(torch.from_numpy(counts), torch.from_numpy(add))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0] == IMAX and want[5] == IMAX


@pytest.mark.parametrize("H", [2000, 40000])
@pytest.mark.parametrize("sentinel", [False, True], ids=["plain", "sentinel"])
def test_count_db_occurrences(H, sentinel):
    """``mash_tpu``'s compare-reduce (H = 2 000) and DB-side search
    (H = 40 000) tiers against the port's one plain version."""
    rng = np.random.default_rng(H + sentinel)
    db = _db(rng, H, sentinel)
    h, v = _chunk(rng, db, 4096, sentinel)
    c0 = rng.integers(0, 50, len(db) + 1).astype(np.int32)
    c0[:3] = IMAX - 1  # saturation on the way
    want = np.asarray(jso.count_db_occurrences(
        jnp.asarray(h), jnp.asarray(v), jnp.asarray(db), jnp.asarray(c0)))
    got = tso.count_db_occurrences(_t64(h), torch.from_numpy(v), _t64(db),
                                   torch.from_numpy(c0))
    np.testing.assert_array_equal(got.numpy(), want)


def _tpu_counter(db, chunks, wblk, rw):
    counter = jso.BigDBCounter(j_params(), db, s=100, chunk_len=1 << 12,
                               d_tile=256, wblk=wblk, rw=rw)
    for h, v in chunks:
        counter.add(jnp.asarray(h), jnp.asarray(v))
    return counter.finalize()


def _port_counter(db, chunks, flush):
    dbt, _, _ = db_table_from_numpy(db, np.zeros(len(db) + 1), np.zeros(0))
    counter = tso.ScreenCounter(dbt, flush_hashes=flush)
    for h, v in chunks:
        counter.add(_t64(h), torch.from_numpy(v))
    return counter.finalize()


@pytest.mark.parametrize("sentinel", [False, True], ids=["plain", "sentinel"])
def test_screen_counter_matches_bigdb_counter(sentinel):
    """Chunks of two lengths; one flush per chunk and one at finalize."""
    rng = np.random.default_rng(23)
    db = _db(rng, 2000, sentinel)
    chunks = [_chunk(rng, db, 4096 if i < 3 else 2048, sentinel)
              for i in range(5)]
    want = _tpu_counter(db, chunks, 4, 4)
    for flush in (3000, 1 << 30):
        got = _port_counter(db, chunks, flush)
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
    np.testing.assert_array_equal(_port_counter(db, chunks, 1 << 20), want)


def test_screen_count_plain_edges():
    """The kernel's plain version: empty and all-EMPTY batches, a DB hash
    of 2^64-1 (left for the caller), saturation."""
    db = _t64(np.array([3, 9, 2**63, SENT], np.uint64))
    counts = torch.tensor([0, IMAX - 1, 7, 0], dtype=torch.int32)
    tsk.screen_count(torch.zeros(0, dtype=torch.int64), db, counts)
    tsk.screen_count(torch.full((5,), -1, dtype=torch.int64), db, counts)
    assert counts.tolist() == [0, IMAX - 1, 7, 0]
    batch = tsketch.biased(torch.sort(tsketch.biased(
        _t64(np.array([9, 9, 9, 3, 2**63, SENT, SENT], np.uint64)))).values)
    tsk.screen_count(batch, db, counts)
    assert counts.tolist() == [1, IMAX, 8, 0]
    with pytest.raises(ValueError):
        tsk.screen_count(batch, db, counts.long())


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


def test_convert_db_table_roundtrip():
    db, seg, ids = jso.build_db_table(
        [np.array([5, 2**64 - 1], np.uint64), np.array([5, 7], np.uint64)])
    dbt, segt, idst = db_table_from_numpy(db, seg, ids)
    assert (dbt.dtype, segt.dtype, idst.dtype) == (
        torch.int64, torch.int64, torch.int32)
    np.testing.assert_array_equal(dbt.numpy().view(np.uint64), db)
    np.testing.assert_array_equal(segt.numpy(), seg)
    np.testing.assert_array_equal(idst.numpy(), ids)
    c = counts_to_numpy(torch.tensor([0, IMAX], dtype=torch.int32))
    assert c.dtype == np.uint32 and c.tolist() == [0, IMAX]
    h, c = state_from_numpy(db, np.ones(3))
    assert h.dtype == torch.int64
