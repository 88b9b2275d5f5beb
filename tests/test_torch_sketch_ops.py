"""mash_tpu_torch.ops.sketch_ops against mash_tpu.ops.sketch_ops.

States must be bit-equal to the reference's full-sort fold, on the
inputs of ``tests/test_sketch_fast_fold.py`` (heavy duplication, subrow
bursts, a tail of valid windows, key ties, 32-bit hashes).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mash_tpu.ops import sketch_ops as js
from mash_tpu_torch.convert import (
    params_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from mash_tpu_torch.ops import sketch_ops as ts

B, N, S = 3, 50001, 100


def _ref_states(h, v, s):
    return jax.vmap(lambda a, b: js.sketch_chunk(a, b, s=s))(
        jnp.asarray(h), jnp.asarray(v)
    )


def _assert_state(ref, got):
    gh, gc = state_to_numpy(got)
    np.testing.assert_array_equal(np.asarray(ref[0]), gh)
    np.testing.assert_array_equal(np.asarray(ref[1]), gc)


def _torch(h, v):
    return torch.from_numpy(h.view(np.int64)), torch.from_numpy(v)


def _rand(rng, hi=2**63):
    return rng.integers(0, hi, size=(B, N), dtype=np.int64).astype(np.uint64)


def _dups(rng):
    return (_rand(rng, 30) << np.uint64(32)) + np.uint64(7)


def _burst(rng):
    h = _rand(rng)
    h[0, 100:600] = np.uint64(12345)  # 500 copies inside one subrow
    return h


def _ties(rng):
    low = rng.integers(0, 2**31, size=(B, N), dtype=np.int64)
    return (np.uint64(5) << np.uint64(32)) | low.astype(np.uint64)


def _top_bit(rng):
    # hashes >= 2^63 are negative as int64: unsigned order must hold
    return _rand(rng) | np.uint64(1 << 63)


@pytest.mark.parametrize(
    "make,p_valid",
    [
        (_rand, 0.9),
        (_dups, 0.9),  # heavy duplication
        (_burst, 0.9),
        (_rand, 0.001),
        (_rand, 0.0),
        (lambda rng: _rand(rng, 2**32), 0.9),
        (_ties, 0.9),
        (_top_bit, 0.9),
    ],
    ids=["random", "duplicates", "burst", "mostly_invalid", "all_invalid",
         "32bit", "hi_key_ties", "top_bit"],
)
def test_sketch_chunk_matches_mash_tpu(make, p_valid):
    rng = np.random.default_rng(3)
    h = make(rng)
    v = rng.random((B, N)) < p_valid
    _assert_state(_ref_states(h, v, S), ts.sketch_chunk(*_torch(h, v), s=S))


def test_tail_only_valid():
    rng = np.random.default_rng(4)
    h = _rand(rng)
    v = np.zeros((B, N), bool)
    v[:, -5:] = True
    _assert_state(_ref_states(h, v, S), ts.sketch_chunk(*_torch(h, v), s=S))


def test_small_and_fewer_than_s():
    h = np.array([5, 5, 7, 9, 2**64 - 2], dtype=np.uint64)
    v = np.array([True, True, True, False, True])
    ref = js.sketch_chunk(jnp.asarray(h), jnp.asarray(v), s=32)
    _assert_state(ref, ts.sketch_chunk(*_torch(h, v), s=32))


def test_merge_and_tree_merge():
    rng = np.random.default_rng(1)
    s = 20
    a = rng.integers(0, 1000, size=500).astype(np.uint64) | np.uint64(
        1 << 63)
    b = rng.integers(0, 1000, size=700).astype(np.uint64)
    ones = lambda x: np.ones(len(x), bool)  # noqa: E731
    ja = js.sketch_chunk(jnp.asarray(a), jnp.asarray(ones(a)), s=s)
    jb = js.sketch_chunk(jnp.asarray(b), jnp.asarray(ones(b)), s=s)
    ta = ts.sketch_chunk(*_torch(a, ones(a)), s=s)
    tb = ts.sketch_chunk(*_torch(b, ones(b)), s=s)
    _assert_state(js.merge_states(ja, jb, s=s),
                  ts.merge_states(ta, tb, s=s))
    stacked_h = jnp.stack([ja[0], jb[0]])
    stacked_c = jnp.stack([ja[1], jb[1]])
    _assert_state(
        js.tree_merge(stacked_h, stacked_c, s=s),
        ts.tree_merge(torch.stack([ta[0], tb[0]]),
                      torch.stack([ta[1], tb[1]]), s=s),
    )
    _assert_state(js.empty_state(s), ts.empty_state(s))


@pytest.mark.parametrize("use64", [True, False])
def test_estimators(use64):
    rng = np.random.default_rng(5)
    hi = 2**64 if use64 else 2**32
    h = np.sort(np.unique(rng.integers(0, hi, 300, dtype=np.uint64)))[:200]
    c = rng.integers(1, 5, len(h))
    pad = 250 - len(h)
    h = np.concatenate([h, np.full(pad, 2**64 - 1, np.uint64)])
    c = np.concatenate([c, np.zeros(pad, np.int64)])
    jstate = (jnp.asarray(h), jnp.asarray(c))
    tstate = state_from_numpy(h, c)
    assert js.state_stats(jstate) == ts.state_stats(tstate)
    assert js.estimate_set_size(jstate, use64) == ts.estimate_set_size(
        tstate, use64)
    assert js.estimate_multiplicity(jstate) == ts.estimate_multiplicity(
        tstate)


def test_candidate_budget_matches():
    for s, n in ((1000, 1 << 20), (50, 40000), (10000, 1 << 20), (1, 10)):
        assert js.candidate_budget(s, 2048, n) == ts.candidate_budget(
            s, 2048, n)


def test_params_from_numpy():
    from mash_tpu.core.params import default_nucleotide_params

    ref = default_nucleotide_params(16, 300, 7)
    ref.set_alphabet("ACGTN")
    got = params_from_numpy(ref)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert (got.use64, got.kmer_space) == (ref.use64, ref.kmer_space)
    assert params_from_numpy(dataclasses.asdict(ref)) == got
