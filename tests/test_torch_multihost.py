"""The port's multi-process helpers (``mash_tpu_torch.parallel.multihost``).

The counterpart of ``test_multihost.py``: the single-process degenerate
case of every helper, the launch environment's validation (the same
messages as ``mash_tpu``'s, under the ``MASH_TPU_TORCH_`` prefix), the
torchrun branch, and, through a real two-rank gloo group in spawned
processes, the count sum at the uint32 limit, the state merge and the
election of a payload of more than 8 KiB.  Every value is an integer or
bytes, so the tolerance is equality.
"""

from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from mash_tpu_torch.ops import sketch_ops
from mash_tpu_torch.parallel import multihost as mh

REPO = str(pathlib.Path(__file__).resolve().parent.parent)
UMAX = 2**32 - 1


@pytest.fixture
def launch_env(monkeypatch):
    """No launch variables of either kind, and no process group."""
    for name in (mh.COORDINATOR_ENV, mh.NUM_PROCESSES_ENV, mh.PROCESS_ID_ENV,
                 "WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert not torch.distributed.is_initialized()
    return monkeypatch


def test_single_process_degenerate_helpers(launch_env):
    assert mh.maybe_init_distributed() is False
    assert mh.process_count() == 1 and mh.process_index() == 0
    paths = ["a", "b", "c", "d"]
    assert mh.shard_paths(paths) == paths
    assert all(mh.owns_stripe(i0, 32) for i0 in (0, 32, 4096))
    assert mh.reduce_meta_across_hosts(3, 10, False) == (3, 10, False)
    assert mh.max_across_hosts(0.25) == 0.25
    counts = np.array([0, 5, UMAX], dtype=np.uint32)
    np.testing.assert_array_equal(mh.sum_counts_across_hosts(counts), counts)
    assert mh.elect_min_with_payload(3, 1, b"x" * 9000) == b"x" * 9000
    assert mh.elect_min_with_payload(-1, 0, b"none") == b""
    np.testing.assert_array_equal(mh.local_device_counts("cpu"), [1])
    state = sketch_ops.empty_state(8)
    assert mh.merge_states_across_hosts(state, 8) is state


def test_env_validation_messages(launch_env):
    """Incomplete or inconsistent launch variables exit with a clear
    diagnostic before any group is joined."""
    launch_env.setenv(mh.COORDINATOR_ENV, "127.0.0.1:1")
    with pytest.raises(SystemExit, match=mh.NUM_PROCESSES_ENV):
        mh.maybe_init_distributed()
    launch_env.setenv(mh.NUM_PROCESSES_ENV, "2")
    with pytest.raises(SystemExit, match=mh.PROCESS_ID_ENV):
        mh.maybe_init_distributed()
    for pid in ("5", "2", "-1"):
        launch_env.setenv(mh.PROCESS_ID_ENV, pid)
        with pytest.raises(SystemExit, match="outside \\[0, 2\\)"):
            mh.maybe_init_distributed()
    assert not torch.distributed.is_initialized()


def test_coordinator_branch_calls_gloo_tcp(launch_env):
    calls = []
    launch_env.setattr(mh.dist, "init_process_group",
                       lambda *a, **kw: calls.append((a, kw)))
    launch_env.setenv(mh.COORDINATOR_ENV, "host0:8476")
    launch_env.setenv(mh.NUM_PROCESSES_ENV, "4")
    launch_env.setenv(mh.PROCESS_ID_ENV, "3")
    assert mh.maybe_init_distributed() is True
    assert calls == [(("gloo",), dict(init_method="tcp://host0:8476",
                                     world_size=4, rank=3))]


def test_torchrun_branch(launch_env):
    """With no MASH_TPU_TORCH_* variables, torchrun's environment joins
    the group through env:// only when it advertises several workers;
    a failed init propagates instead of running single-process."""
    calls = []
    launch_env.setattr(mh.dist, "init_process_group",
                       lambda *a, **kw: calls.append((a, kw)))
    assert mh.maybe_init_distributed() is False
    launch_env.setenv("WORLD_SIZE", "1")
    assert mh.maybe_init_distributed() is False
    assert calls == []
    launch_env.setenv("WORLD_SIZE", "2")
    assert mh.maybe_init_distributed() is True
    assert calls == [(("gloo",), dict(init_method="env://"))]

    def fail(*_a, **_kw):
        raise RuntimeError("rendezvous failed")

    launch_env.setattr(mh.dist, "init_process_group", fail)
    with pytest.raises(RuntimeError, match="rendezvous failed"):
        mh.maybe_init_distributed()


def test_real_init_failure_propagates(launch_env):
    """An init that cannot succeed (rank 1 of 2 with no rank 0, a short
    timeout) raises; it never degrades to a single-process run."""
    code = textwrap.dedent("""
        import datetime, torch.distributed as dist
        from mash_tpu_torch.parallel import multihost as mh
        real = dist.init_process_group
        dist.init_process_group = lambda *a, **kw: real(
            *a, timeout=datetime.timedelta(seconds=3), **kw)
        try:
            mh.maybe_init_distributed()
        except Exception as e:
            print("RAISED", type(e).__name__)
        else:
            print("JOINED", mh.process_count())
    """)
    env = dict(os.environ, PYTHONPATH=REPO, **{
        mh.COORDINATOR_ENV: "127.0.0.1:%d" % _free_port(),
        mh.NUM_PROCESSES_ENV: "2", mh.PROCESS_ID_ENV: "1"})
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert "RAISED" in out.stdout, (out.stdout, out.stderr[-2000:])


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# Run in each of two ranks: the helpers on per-rank inputs; prints one
# JSON line of results.
_TWO_RANK_CODE = textwrap.dedent("""
    import json
    import numpy as np
    import torch
    from mash_tpu_torch.ops import sketch_ops
    from mash_tpu_torch.parallel import multihost as mh

    assert mh.maybe_init_distributed()
    assert mh.maybe_init_distributed()  # a second call reuses the group
    rank = mh.process_index()
    res = {"count": mh.process_count(), "rank": rank}
    # uint32 counts at the limit: summed in 64 bits, saturated at 2^32-1
    mine = [2**32 - 2, 2**31, 2**31 + 5] if rank == 0 else [5, 2**31 - 1, 3]
    res["sum"] = mh.sum_counts_across_hosts(
        np.array(mine, dtype=np.uint32)).tolist()
    res["meta"] = list(mh.reduce_meta_across_hosts(
        10 + rank, 100 * (rank + 1), rank == 1))
    res["max"] = mh.max_across_hosts([0.25, 0.75][rank])
    res["counts"] = mh.local_device_counts("cpu").tolist()
    res["shard"] = mh.shard_paths(["f0", "f1", "f2", "f3", "f4"])
    res["owns"] = [mh.owns_stripe(i0, 32) for i0 in range(0, 160, 32)]
    # rank 0 has no candidate; rank 1's payload is over 8 KiB
    big = ("name\\x00" + "c" * 9000).encode()
    got = (mh.elect_min_with_payload(-1, 0, b"") if rank == 0
           else mh.elect_min_with_payload(4, 1, big))
    res["elected_len"] = len(got)
    res["elected_ok"] = got == big
    # nobody has a candidate
    res["none"] = mh.elect_min_with_payload(-1, 0, b"zz").decode()
    # ties on the first key: the smaller second key wins, whichever rank
    res["tie"] = mh.elect_min_with_payload(
        2, [3, 1][rank], b"rank%d" % rank).decode()
    rng = np.random.default_rng(rank)
    h = np.sort(rng.choice(2**40, size=16, replace=False)).astype(np.int64)
    state = (torch.from_numpy(h), torch.ones(16, dtype=torch.int64))
    mh_ = mh.merge_states_across_hosts(state, 16)
    res["merged"] = mh_[0].tolist()
    res["merged_counts"] = mh_[1].tolist()
    print("RESULT " + json.dumps(res))
""")


@pytest.fixture(scope="module")
def two_ranks():
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **{
            mh.COORDINATOR_ENV: "127.0.0.1:%d" % port,
            mh.NUM_PROCESSES_ENV: "2", mh.PROCESS_ID_ENV: str(rank)})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _TWO_RANK_CODE], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    res = []
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-3000:]
        line = next(ln for ln in so.splitlines() if ln.startswith("RESULT "))
        res.append(json.loads(line[len("RESULT "):]))
    return res


def test_two_rank_sum_counts_saturates_at_uint32_max(two_ranks):
    """2^32-2 + 5 saturates at 2^32-1; 2^31 + (2^31-1) = 2^32-1 and
    2^31+5 + 3 pass 2^31-1 unclamped: the per-process dtype's max is the
    limit, not the big-DB tier's 2^31-1 (as in mash_tpu)."""
    for r in two_ranks:
        assert r["count"] == 2
        assert r["sum"] == [UMAX, UMAX, 2**31 + 8]


def test_two_rank_meta_max_shards_and_stripes(two_ranks):
    r0, r1 = two_ranks
    assert r0["meta"] == r1["meta"] == [21, 300, True]
    assert r0["max"] == r1["max"] == 0.75
    assert r0["counts"] == r1["counts"] == [1, 1]
    assert r0["shard"] == ["f0", "f2", "f4"] and r1["shard"] == ["f1", "f3"]
    assert r0["owns"] == [True, False, True, False, True]
    assert r1["owns"] == [not o for o in r0["owns"]]


def test_two_rank_elect_payload_over_8kib(two_ranks):
    """Rank 0 has no candidate and rank 1 a payload of 9005 bytes: both
    ranks receive it whole."""
    for r in two_ranks:
        assert r["elected_ok"] and r["elected_len"] == 9005
        assert r["none"] == ""
        assert r["tie"] == "rank1"


def test_two_rank_merge_states(two_ranks):
    """Every rank ends with the bottom-16 of the union of both states."""
    want = np.sort(np.unique(np.concatenate([
        np.sort(np.random.default_rng(r).choice(2**40, size=16,
                                                 replace=False))
        for r in (0, 1)])))[:16]
    for r in two_ranks:
        np.testing.assert_array_equal(r["merged"], want)
        assert sum(r["merged_counts"]) == 16
