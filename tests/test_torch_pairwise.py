"""mash_tpu_torch pairwise intersection against mash_tpu's Pallas kernels.

On CPU tensors ``pairwise64`` / ``pairwise32`` run their plain version
(``distance.pairwise_common_denom``); both must equal the reference's
Pallas kernels in interpret mode, and ``rank_compress`` must give the
reference's keys.  The CUDA kernels are held against the same plain
version on the GPU by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mash_tpu.ops import distance as jd
from mash_tpu.ops.pallas_pairwise import (
    pairwise_common_denom_keys32,
    pairwise_common_denom_pallas,
)
from mash_tpu_torch.ops import distance as td
from mash_tpu_torch.ops import pairwise_kernel as pk

EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)


def _mk(rng, n, s, universe, bits=64):
    H = np.full((n, s), EMPTY)
    N = np.zeros(n, np.int32)
    for i in range(n):
        m = int(rng.integers(max(1, s // 2), s + 1))
        vals = rng.choice(universe, size=m, replace=False).astype(np.uint64)
        if bits == 64:
            vals = vals * np.uint64(0x9E3779B97F4A7C15)  # spans 2^64
        else:
            vals = (vals * np.uint64(2654435761)) % np.uint64(2**32)
        H[i, :m] = np.sort(vals)
        N[i] = m
    return H, N


def _t(a):
    return torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64 else a)


CASES = [(5, 9, 40, 40), (3, 3, 17, 10), (12, 4, 100, 100),
         (9, 130, 64, 64), (7, 11, 300, 250)]


@pytest.mark.parametrize("nq,nr,s,cap", CASES)
def test_pairwise64_matches_pallas(nq, nr, s, cap):
    rng = np.random.default_rng(nq * 1000 + nr)
    qh, qn = _mk(rng, nq, s, 3 * s)
    rh, rn = _mk(rng, nr, s, 3 * s)
    c0, d0 = pairwise_common_denom_pallas(
        jnp.asarray(qh), jnp.asarray(qn), jnp.asarray(rh), jnp.asarray(rn),
        cap=cap)
    c1, d1 = pk.pairwise64(_t(qh), _t(qn), _t(rh), _t(rn), cap=cap)
    np.testing.assert_array_equal(np.asarray(c0), c1.numpy())
    np.testing.assert_array_equal(np.asarray(d0), d1.numpy())
    c2, d2 = td.pairwise_common_denom_auto(_t(qh), _t(qn), _t(rh), _t(rn),
                                           cap=cap)
    np.testing.assert_array_equal(np.asarray(c0), c2.numpy())
    np.testing.assert_array_equal(np.asarray(d0), d2.numpy())


@pytest.mark.parametrize("nq,nr,s,cap", CASES[:3])
def test_rank_compress_and_pairwise32(nq, nr, s, cap):
    rng = np.random.default_rng(nq + nr + s)
    qh, qn = _mk(rng, nq, s, 3 * s)
    rh, rn = _mk(rng, nr, s, 3 * s)
    jkq, jkr = jd.rank_compress(jnp.asarray(qh), jnp.asarray(rh))
    kq, kr = td.rank_compress(_t(qh), _t(rh))
    np.testing.assert_array_equal(np.asarray(jkq).view(np.int32), kq.numpy())
    np.testing.assert_array_equal(np.asarray(jkr).view(np.int32), kr.numpy())
    c0, d0 = pairwise_common_denom_keys32(jkq, jnp.asarray(qn), jkr,
                                          jnp.asarray(rn), cap=cap)
    c1, d1 = pk.pairwise32(kq, _t(qn), kr, _t(rn), cap=cap)
    np.testing.assert_array_equal(np.asarray(c0), c1.numpy())
    np.testing.assert_array_equal(np.asarray(d0), d1.numpy())


@pytest.mark.parametrize("nq,nr,s,cap", [(5, 9, 40, 40), (6, 3, 70, 33)])
def test_pairwise32_on_32bit_hashes(nq, nr, s, cap):
    """k <= 16 sketches: the low word carries the hash."""
    rng = np.random.default_rng(nq + 7 * nr)
    qh, qn = _mk(rng, nq, s, 3 * s, bits=32)
    rh, rn = _mk(rng, nr, s, 3 * s, bits=32)
    c0, d0 = pairwise_common_denom_pallas(
        jnp.asarray(qh), jnp.asarray(qn), jnp.asarray(rh), jnp.asarray(rn),
        cap=cap, use64=False)
    c1, d1 = pk.pairwise32(_t(qh).to(torch.int32), _t(qn),
                           _t(rh).to(torch.int32), _t(rn), cap=cap)
    np.testing.assert_array_equal(np.asarray(c0), c1.numpy())
    np.testing.assert_array_equal(np.asarray(d0), d1.numpy())


def test_tiled_and_streamed_match_reference():
    rng = np.random.default_rng(11)
    s = 60
    qh, qn = _mk(rng, 45, s, 2 * s)
    rh, rn = _mk(rng, 70, s, 2 * s)
    c0, d0 = jd.pairwise_common_denom(
        jnp.asarray(qh), jnp.asarray(qn), jnp.asarray(rh), jnp.asarray(rn),
        cap=s)
    c1, d1 = td.common_denom_tiled(qh, qn, rh, rn, s, "cpu", tile_q=16,
                                   tile_r=24)
    np.testing.assert_array_equal(np.asarray(c0), c1)
    np.testing.assert_array_equal(np.asarray(d0), d1)
    rows = np.concatenate([st for _, st in td.stream_pair_stripes(
        qh, qn, rh, rn, s, "cpu", row_block=8, tile_r=32)])
    np.testing.assert_array_equal(np.asarray(c0), rows & 0xFFFF)
    np.testing.assert_array_equal(np.asarray(d0), rows >> 16)
    # every sketch full: only common leaves the device
    full = np.full_like(qn, s)
    fr = np.full_like(rn, s)
    c2, d2 = jd.pairwise_common_denom(
        jnp.asarray(qh), jnp.asarray(full), jnp.asarray(rh),
        jnp.asarray(fr), cap=s)
    rows = np.concatenate([st for _, st in td.stream_pair_stripes(
        qh, full, rh, fr, s, "cpu", row_block=16)])
    np.testing.assert_array_equal(np.asarray(c2), rows & 0xFFFF)
    np.testing.assert_array_equal(np.asarray(d2), rows >> 16)


def test_wrappers_reject_bad_input():
    h = torch.zeros((2, 5), dtype=torch.int64)
    n = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        pk.pairwise64(h, n, h[:, :4].contiguous(), n, cap=5)
    with pytest.raises(ValueError):
        pk.pairwise32(h, n, h, n, cap=5)
    with pytest.raises(ValueError):
        pk.pairwise64(h, n.long(), h, n, cap=5)
