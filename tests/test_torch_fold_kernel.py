"""mash_tpu_torch.ops.fold_kernel (K6's wrapper and twins) on the CPU.

The plain fold is held against ``mash_tpu.ops.sketch_ops``'
``_fold_sorted``, ``merge_states``, ``tree_merge`` and ``sketch_chunk`` on
JAX-CPU, at the kernel's edges: hashes shared across segments, a real
2^64-1 with a count above 0, real hashes with a count of 0, all-empty
rows, fewer than s distinct, s = 1, one segment, odd widths and 32-bit
hashes.  The candidate fold's twin is held against the fold and
certificate that ``sketch_kernel.sketch_chunks_deferred`` ran before K6
(copied below), on K1's candidates from ``sketch_select_plain``, with
rows that pass each clause of the certificate and rows that fail it; the
states that come out against ``mash_tpu``'s ``sketch_chunks_auto``.  The
kernel itself runs only on the card (``tests/test_torch_gpu.py``).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mash_tpu.core.params import default_nucleotide_params
from mash_tpu.ops import pallas_sketch as ps
from mash_tpu.ops import sketch_ops as js
from mash_tpu.ops.kmers import alphabet_bytes
from mash_tpu_torch.ops import fold_kernel as fk
from mash_tpu_torch.ops import sketch_kernel as sk
from mash_tpu_torch.ops import sketch_ops as ts

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)
DNA = alphabet_bytes(default_nucleotide_params().alphabet)


def _rows(seed, B, G, W, *, empty=0.0, dup=0.0, realmax=0.0, zero=0.0,
          hi=2**64 - 1):
    """uint64 hashes and int64 counts ``[B, G, W]``, each segment sorted
    (see ``tests/test_torch_gpu.py::_fold_rows``)."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, hi, (B, G, W), dtype=np.uint64, endpoint=True)
    pool = rng.integers(0, hi, 64, dtype=np.uint64, endpoint=True)
    pick = rng.random(h.shape) < dup
    h[pick] = pool[rng.integers(0, 64, int(pick.sum()))]
    c = rng.integers(1, 4, h.shape).astype(np.int64)
    c[(rng.random(h.shape) < zero) & (h != EMPTY)] = 0
    gone = rng.random(h.shape) < empty
    h[gone], c[gone] = EMPTY, 0
    real = rng.random(h.shape) < realmax
    h[real], c[real] = EMPTY, 2
    order = np.argsort(h, axis=2, kind="stable")
    return (np.take_along_axis(h, order, 2),
            np.take_along_axis(c, order, 2))


def _torch(h, c):
    B = h.shape[0]
    return (torch.from_numpy(np.ascontiguousarray(h).reshape(B, -1)
                             .view(np.int64)),
            torch.from_numpy(np.ascontiguousarray(c).reshape(B, -1)))


@functools.partial(jax.jit, static_argnames="s")
def _ref_rows(h, c, s):
    def one(hh, cc):
        hh, cc = jax.lax.sort((hh, cc), num_keys=1)
        return js._fold_sorted(hh, cc, s)

    return jax.vmap(one)(h, c)


def _ref_fold(h, c, s):
    """mash_tpu: the row's entries sorted together, then ``_fold_sorted``."""
    B = h.shape[0]
    return _ref_rows(jnp.asarray(h.reshape(B, -1)),
                     jnp.asarray(c.reshape(B, -1)), s=s)


def _assert_states(ref, got):
    np.testing.assert_array_equal(np.asarray(ref[0]),
                                  got[0].numpy().view(np.uint64))
    np.testing.assert_array_equal(np.asarray(ref[1]), got[1].numpy())


# name: (rows, segments, width, s, edges)
CASES = {
    "dup_across": (3, 6, 40, 60, {"dup": 0.5}),
    "realmax": (3, 4, 30, 200, {"realmax": 0.05, "empty": 0.2}),
    "realmax_cut": (3, 4, 30, 20, {"realmax": 0.1, "empty": 0.3}),
    "zero_counts": (3, 4, 32, 50, {"zero": 0.3, "empty": 0.1}),
    "all_empty": (2, 3, 25, 30, {"empty": 1.0}),
    "few_distinct": (3, 5, 20, 300, {"dup": 0.9}),
    "s1": (4, 7, 13, 1, {"dup": 0.3}),
    "one_segment": (3, 1, 500, 40, {"dup": 0.6, "empty": 0.2}),
    "odd_width": (2, 9, 77, 35, {"empty": 0.1}),
    "bits32": (3, 8, 64, 100, {"hi": 2**32 - 1, "empty": 0.3}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fold_sorted_matches_mash_tpu(case):
    B, G, W, s, edges = CASES[case]
    h, c = _rows(list(CASES).index(case), B, G, W, **edges)
    th, tc = _torch(h, c)
    before = dict(fk.LAUNCHES)
    ref = _ref_fold(h, c, s)
    _assert_states(ref, fk.fold_sorted(th, tc, s, G))
    _assert_states(ref, fk.fold_sorted_plain(th, tc, s, G))
    assert fk.LAUNCHES == before  # the CPU never launches


@pytest.mark.parametrize("case", ["dup_across", "realmax", "zero_counts",
                                  "all_empty", "s1", "bits32"])
def test_merge_states_and_tree_merge_match_mash_tpu(case):
    """States of one width: ``merge_states`` (two segments) and
    ``tree_merge`` (``[G, w]``), as ``mash_tpu`` merges them."""
    _, G, W, s, edges = CASES[case]
    h, c = _rows(list(CASES).index(case) + 50, 1, G, W, **edges)
    h, c = h[0], c[0]
    th, tc = torch.from_numpy(h.view(np.int64)), torch.from_numpy(c)
    _assert_states(js.tree_merge(jnp.asarray(h), jnp.asarray(c), s=s),
                   ts.tree_merge(th, tc, s=s))
    pair = [(jnp.asarray(h[i]), jnp.asarray(c[i])) for i in (0, 1)]
    _assert_states(js.merge_states(*pair, s=s),
                   ts.merge_states((th[0], tc[0]), (th[1], tc[1]), s=s))
    one = js.tree_merge(jnp.asarray(h[:1]), jnp.asarray(c[:1]), s=s)
    _assert_states(one, ts.tree_merge(th[:1], tc[:1], s=s))


@pytest.mark.parametrize("p_valid,hi", [(0.9, 2**64 - 1), (0.002, 2**64 - 1),
                                        (0.0, 2**64 - 1), (0.7, 2**32 - 1)],
                         ids=["random", "few_valid", "none_valid", "bits32"])
def test_sketch_chunk_matches_mash_tpu(p_valid, hi):
    """``sketch_chunk``: sort, then the fold of one sorted segment."""
    rng = np.random.default_rng(7)
    h = rng.integers(0, hi, (3, 3000), dtype=np.uint64, endpoint=True)
    h[:, ::97] = EMPTY  # valid windows whose hash is 2^64-1
    h[0, 1000:1400] = h[0, 5]  # a run of one hash
    v = rng.random(h.shape) < p_valid
    ref = jax.vmap(lambda a, b: js.sketch_chunk(a, b, s=150))(
        jnp.asarray(h), jnp.asarray(v))
    got = ts.sketch_chunk(torch.from_numpy(h.view(np.int64)),
                          torch.from_numpy(v), s=150)
    _assert_states(ref, got)


def _parent_tail(cand, boundary, vcount, B, s):
    """The fold and certificate of ``sketch_chunks_deferred`` before K6,
    as it was, with each clause of the certificate."""
    R = cand.shape[0] // B
    ch = cand.view(B, R * cand.shape[1])
    cand_v = ch != -1
    ch, cc = fk.sort_unsigned(ch, cand_v.long())
    Hf, Cf = fk._fold_sorted(ch, cc, s)
    ndist = (Cf > 0).sum(dim=1)
    minb = fk.biased(boundary.view(B, R)).min(dim=1).values
    covered = (ndist >= s) & (fk.biased(Hf[:, s - 1]) < minb)
    all_in = vcount.view(B, R).sum(dim=1) == cand_v.sum(dim=1)
    bad = ~(covered | all_in)
    Hf, Cf = fk.empty_rows(Hf, Cf, bad)
    return Hf, Cf, bad, covered, all_in


def _chunks():
    """Rows that pass the certificate by its first clause alone (random,
    many windows a subrow), by its second alone (few valid windows: every
    one a candidate, fewer than s), by both (exactly s distinct, all
    captured), and fail it (a short tail, a repeated motif)."""
    rng = np.random.default_rng(11)
    rows = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), (5, 24 * 1024))
    rows[1, 2048 + 20:] = 0  # tail: 2048 valid windows, m < 2048
    rows[2] = np.resize(rng.choice(np.frombuffer(b"ACGT", np.uint8), 37),
                        rows.shape[1])  # motif: 37 distinct hashes
    rows[3, 300:] = ord("N")  # all captured, fewer than s
    rows[4, :] = ord("N")
    rows[4, :3000:100] = ord("A")
    return np.ascontiguousarray(rows)


@pytest.mark.parametrize("s", [60, 700])
def test_fold_candidates_plain_matches_parent_tail(s):
    x = torch.from_numpy(_chunks())
    kw = dict(alphabet=DNA, k=21, seed=42, use64=True, noncanonical=False,
              preserve_case=False)
    m = ts.candidate_budget(s, sk.C, x.shape[1] - 20)
    cand, boundary, vcount = sk.sketch_select_plain(x, **kw, m=m)
    B = x.shape[0]
    want = _parent_tail(cand, boundary, vcount, B, s)
    for got in (fk.fold_candidates(cand, boundary, vcount, B, s),
                fk.fold_candidates_plain(cand, boundary, vcount, B, s)):
        assert all(torch.equal(g, w) for g, w in zip(got, want[:3]))
    _, _, bad, covered, all_in = want
    assert bad.any() and (~bad).any()
    assert (covered & ~all_in).any() and (all_in & ~covered).any()


def test_candidate_route_states_match_mash_tpu():
    """Bytes -> states through K1's twin, the candidate fold's twin and
    the recompute of the rows without the certificate, against
    ``mash_tpu``'s ``sketch_chunks_auto`` (its XLA route on the CPU)."""
    rows = _chunks()
    kw = dict(alphabet=DNA, k=21, seed=42, use64=True, noncanonical=False,
              preserve_case=False)
    for s in (60, 700):
        ref = ps.sketch_chunks_auto(jnp.asarray(rows), **kw, s=s)
        _assert_states(ref, sk.sketch_chunks_fused(torch.from_numpy(rows),
                                                   **kw, s=s))
        H, C, pending = sk.sketch_chunks_deferred(torch.from_numpy(rows),
                                                  **kw, s=s)
        sel, h, c = pending.states()
        assert 2 in sel.tolist() and int(C[sel].sum()) == 0
        H[sel], C[sel] = h, c
        _assert_states(ref, (H, C))


def test_refusals():
    h = torch.zeros((2, 12), dtype=torch.int64)
    for args in ((h.int(), h.int(), 4), (h, h[:, :6], 4),
                 (h[:, ::2], h[:, ::2], 4), (h, h, 0), (h, h, 4, 5),
                 (h, h, 4, 0), (h[0, 0], h[0, 0], 4)):
        with pytest.raises(ValueError):
            fk.fold_sorted(*args)
    with pytest.raises(ValueError):
        fk.fold_sorted(h.to("meta"), h.to("meta"), 4)
    cand = torch.zeros((6, 4), dtype=torch.int64)
    b, v = torch.zeros(6, dtype=torch.int64), torch.zeros(6, dtype=torch.int32)
    for args in ((cand.int(), b, v, 2, 3), (cand, b, v, 4, 3),
                 (cand, b, v.long(), 2, 3), (cand, b[:5], v, 2, 3),
                 (cand, b, v, 2, 0), (cand.t(), b[:4], v[:4], 2, 3),
                 (cand[0], b, v, 2, 3)):
        with pytest.raises(ValueError):
            fk.fold_candidates(*args)
    with pytest.raises(ValueError):
        ts.merge_states((h[0], h[0]), (h[0, :6], h[0, :6]), s=4)
