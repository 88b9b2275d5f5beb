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
MAX64 = int(EMPTY)


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


def _with_max32(rng, nq, nr, s):
    """32-bit hash rows (int64 values, EMPTY pads) where most rows hold
    the real hash 0xFFFFFFFF, the largest, as their last value."""
    qh, qn = _mk(rng, nq, s, 3 * s, bits=32)
    rh, rn = _mk(rng, nr, s, 3 * s, bits=32)
    for H, N in ((qh, qn), (rh, rn)):
        for i in range(len(N) - 1):
            if np.uint64(0xFFFFFFFF) not in H[i, : N[i]]:
                H[i, N[i] - 1] = 0xFFFFFFFF  # replaces its largest
    return qh, qn, rh, rn


@pytest.mark.parametrize("nq,nr,s,cap", [(5, 9, 40, 40), (6, 3, 70, 33),
                                         (4, 7, 17, 100)])
def test_rank_route_keeps_32bit_max(nq, nr, s, cap):
    """k <= 16 on CUDA ranks the hashes for ``pairwise32``: a real hash
    0xFFFFFFFF gets a rank, where an int32 cast made it the pad key."""
    qh, qn, rh, rn = _with_max32(np.random.default_rng(nq + nr + s),
                                 nq, nr, s)
    c0, d0 = jd.pairwise_common_denom(
        jnp.asarray(qh), jnp.asarray(qn), jnp.asarray(rh), jnp.asarray(rn),
        cap=cap)
    kq, kr = td.rank_compress(_t(qh), _t(rh))
    assert int(kq.max()) < 2**31 - 1 and int((kq == -1).sum()) == int(
        (qh == EMPTY).sum())
    c1, d1 = pk.pairwise32(kq, _t(qn), kr, _t(rn), cap=cap)
    np.testing.assert_array_equal(np.asarray(c0), c1.numpy())
    np.testing.assert_array_equal(np.asarray(d0), d1.numpy())
    # the probe of the fault: q = [5, 9, max], r = [5, 7, max] -> 2 / 4
    q = np.array([[5, 9, 0xFFFFFFFF]], np.uint64)
    r = np.array([[5, 7, 0xFFFFFFFF]], np.uint64)
    n = np.array([3], np.int32)
    kq, kr = td.rank_compress(_t(q), _t(r))
    c, d = pk.pairwise32(kq, _t(n), kr, _t(n), cap=10)
    assert (int(c[0, 0]), int(d[0, 0])) == (2, 4)


@pytest.mark.parametrize("route", ["auto", "stripes"])
def test_32bit_routes_keep_max(route):
    rng = np.random.default_rng(5)
    qh, qn, rh, rn = _with_max32(rng, 11, 21, 30)
    cap = 30
    c0, d0 = jd.pairwise_common_denom(
        jnp.asarray(qh), jnp.asarray(qn), jnp.asarray(rh), jnp.asarray(rn),
        cap=cap)
    if route == "auto":
        c1, d1 = (a.numpy() for a in td.pairwise_common_denom_auto(
            _t(qh), _t(qn), _t(rh), _t(rn), cap=cap, use64=False))
    else:
        rows = np.concatenate([st for _, st in td.stream_pair_stripes(
            qh, qn, rh, rn, cap, "cpu", row_block=4, tile_r=8)])
        c1, d1 = rows & 0xFFFF, rows >> 16
    np.testing.assert_array_equal(np.asarray(c0), c1)
    np.testing.assert_array_equal(np.asarray(d0), d1)


def thread_walk(a, na, b, nb, cap):
    """Mash's capped merge walk (``CommandDistance.cpp:336-425``) as the
    thread route of ``csrc/pairwise.cu`` runs it over the first ``na`` /
    ``nb`` values of two sorted rows: one union value a step, both rows
    advancing on a match (2^64 - 1 never matches: A's goes first), and
    the matches counted at the end as (values consumed) - (steps).  Full
    rows (both sizes >= cap) take exactly ``cap`` steps; otherwise the
    walk stops after ``cap`` steps or when a row runs out, and the other
    row's remainder completes the union."""
    i = j = u = 0

    def step():
        nonlocal i, j
        eq = a[i] == b[j] != MAX64
        i, j = i + (a[i] <= b[j]), j + (b[j] < a[i] or eq)

    if na >= cap and nb >= cap:
        for u in range(1, cap + 1):
            step()
    else:
        while u < cap and i < na and j < nb:
            step()
            u += 1
    denom = cap if u >= cap else min(cap, u + (na - i) + (nb - j))
    return i + j - u, denom


# merged positions per lane (odd) and per warp round in csrc/pairwise.cu
LANE_E = 15
ROUND = 32 * LANE_E


def warp_walk(a, na, b, nb, cap):
    """The warp route of ``csrc/pairwise.cu`` lane by lane: rounds of 32 lanes
    that each find their start by a diagonal search and merge LANE_E
    positions (ties take A first; a match is a B value equal to the A
    value before it), union ranks from a scan of the lanes' match counts,
    lanes past the cap skipped, and a match straddling the last round's
    end resolved after the loop."""
    i0 = j0 = u0 = cnt = 0
    while u0 < cap and i0 < na and j0 < nb:
        rem_a, rem_b = na - i0, nb - j0
        total = rem_a + rem_b
        before = 0  # matches of the earlier lanes
        end = (na, nb)
        for lane in range(32):
            d = lane * LANE_E
            end, mask = (na, nb), 0
            if d < total and u0 + d // 2 <= cap:
                lo, hi = max(0, d - rem_b), min(d, rem_a)
                while lo < hi:
                    mid = (lo + hi) // 2
                    if a[i0 + mid] <= b[j0 + d - 1 - mid]:
                        lo = mid + 1
                    else:
                        hi = mid
                i, j = i0 + lo, j0 + d - lo
                prev = a[i - 1] if i > 0 else None
                for e in range(min(LANE_E, total - d)):
                    if i < na and (j >= nb or a[i] <= b[j]):
                        prev = a[i]
                        i += 1
                    else:
                        if b[j] == prev and b[j] != MAX64:
                            mask |= 1 << e
                        j += 1
                end = (i, j)
            rank0 = u0 + d + 1 - before
            k = 0
            for e in range(LANE_E):
                if mask >> e & 1:
                    k += 1
                    if rank0 + e - k > cap:
                        break
                    cnt += 1
            before += bin(mask).count("1")
        u0 += min(ROUND, total) - before
        i0, j0 = end  # the last lane's cursors
    straddle = (u0 <= cap and i0 > 0 and j0 < nb and b[j0] == a[i0 - 1]
                and b[j0] != MAX64)
    denom = cap if u0 >= cap else min(
        cap, u0 + (na - i0) + (nb - j0) - straddle)
    return cnt + straddle, denom


def _walk_case(case):
    """(qry, nq, ref, nr, cap) numpy rows of one walk case."""
    rng = np.random.default_rng(len(case) * 31 + sum(map(ord, case)))
    kind, _, arg = case.partition("_")
    if kind == "s":  # random rows of width s, some short, one empty
        s = int(arg)
        qh, qn = _mk(rng, 4, s, 2 * s + 1)
        rh, rn = _mk(rng, 5, s, 2 * s + 1)
        qh[3], qn[3] = EMPTY, 0
        return qh, qn, rh, rn, s
    s = 100
    qh, qn = _mk(rng, 3, s, 3 * s)
    qn[:] = s
    qh[:] = np.sort(rng.choice(np.arange(1, 10 * s, dtype=np.uint64),
                               (3, s)), 1)
    qh = np.stack([np.unique(np.concatenate(
        [row, np.arange(10 * s, 11 * s, dtype=np.uint64)]))[:s]
        for row in qh])
    if kind == "identical":
        return qh, qn, qh, qn, s
    if kind == "disjoint":
        return qh, qn, qh + np.uint64(20 * s), qn, s
    if kind == "capbelow":
        return qh, qn, qh[::-1].copy(), qn, s // 3
    if kind == "capabove":  # short rows: the union ends before the cap
        qn[:] = [7, 30, 0]
        for row, n in zip(qh, qn):
            row[n:] = EMPTY
        return qh, qn, qh[::-1].copy(), qn[::-1].copy(), 2 * s + 1
    if kind == "max64":  # 2^64 - 1 as the last real value of both rows
        h = np.full((2, 5), EMPTY)
        h[:, :3] = [[3, 5, MAX64], [3, 6, MAX64]]
        n = np.array([3, 3], np.int32)
        return h, n, h.copy(), n.copy(), int(arg)
    if kind == "straddle":  # a match split by a round's end, at the cap
        w = ROUND // 2 + 64
        a = np.full((2, w), EMPTY)
        a[0, : ROUND // 2 + 1] = np.arange(ROUND // 2 + 1)
        a[1, : ROUND // 2 + 2] = np.arange(ROUND // 2 + 2)
        b = np.full((1, w), EMPTY)
        b[0, : ROUND // 2 + 60] = np.arange(1, ROUND // 2 + 61)
        na = np.array([ROUND // 2 + 1, ROUND // 2 + 2], np.int32)
        return a, na, b, np.array([ROUND // 2 + 60], np.int32), int(arg)
    raise ValueError(case)


WALK_CASES = ["s_1", "s_31", "s_32", "s_33", "s_100", "identical",
              "disjoint", "capbelow", "capabove", "max64_3", "max64_10",
              "straddle_240",
              "straddle_241", "straddle_1000"]


@pytest.mark.parametrize("case", WALK_CASES)
def test_capped_walk_matches_reference(case):
    """The walk the CUDA kernels implement, as the thread route's
    sequential loop and as the warp route's lane-parallel rounds, against
    ``mash_tpu``."""
    qh, qn, rh, rn, cap = _walk_case(case)
    c0, d0 = jd.pairwise_common_denom(
        jnp.asarray(qh), jnp.asarray(qn), jnp.asarray(rh), jnp.asarray(rn),
        cap=cap)
    c0, d0 = np.asarray(c0), np.asarray(d0)
    for x in range(len(qn)):
        a = [int(v) for v in qh[x]]
        for y in range(len(rn)):
            b = [int(v) for v in rh[y]]
            want = (int(c0[x, y]), int(d0[x, y]))
            assert thread_walk(a, qn[x], b, rn[y], cap) == want, (x, y)
            assert warp_walk(a, qn[x], b, rn[y], cap) == want, (x, y)
    if case == "identical":
        assert (c0.diagonal() == cap).all() and (d0.diagonal() == cap).all()
    if case == "disjoint":
        assert (c0 == 0).all() and (d0 == cap).all()


def test_wrappers_reject_bad_input():
    h = torch.zeros((2, 5), dtype=torch.int64)
    n = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        pk.pairwise64(h, n, h[:, :4].contiguous(), n, cap=5)
    with pytest.raises(ValueError):
        pk.pairwise32(h, n, h, n, cap=5)
    with pytest.raises(ValueError):
        pk.pairwise64(h, n.long(), h, n, cap=5)
