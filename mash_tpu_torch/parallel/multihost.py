"""Multi-process execution over ``torch.distributed``.

The counterpart of ``mash_tpu.parallel.multihost``.  The reference is
strictly single-node (pthreads only), so this layer is an extension: N
processes, each driving its local devices, coordinated by a gloo process
group.  All cross-process communication is a few small, associative
merges of host arrays (``mash_tpu`` moves host numpy through
``process_allgather`` too, so gloo on CPU tensors is the faithful
counterpart, and several ranks may share one card):

- **sketch** (reads mode, pooled): input files are sharded across
  processes (``shard_paths``); each folds its shard on its devices; the
  per-process bottom-s states (s * 16 bytes) are all-gathered and folded,
  exact because the fold is associative and commutative.
- **screen**: the same input sharding; the per-process DB-occurrence
  count vectors are summed, and the cardinality states merge like sketch
  states.
- **triangle / dist**: row stripes are owned round-robin by process
  index (``owns_stripe``); each process computes and prints only its
  stripes, so the outputs concatenate in stripe order with no
  communication.

Launch: run the same CLI in every process with

    MASH_TPU_TORCH_COORDINATOR=host0:8476
    MASH_TPU_TORCH_NUM_PROCESSES=N
    MASH_TPU_TORCH_PROCESS_ID=<0..N-1>

or under ``torchrun`` (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
``MASTER_PORT``).  A single process is the degenerate case of every
helper here and needs no process group.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist

COORDINATOR_ENV = "MASH_TPU_TORCH_COORDINATOR"
NUM_PROCESSES_ENV = "MASH_TPU_TORCH_NUM_PROCESSES"
PROCESS_ID_ENV = "MASH_TPU_TORCH_PROCESS_ID"


def maybe_init_distributed() -> bool:
    """Join the gloo process group the environment describes
    (idempotent).

    Returns True if a multi-process group was (or already is)
    initialized; False for plain single-process runs.  A real init
    failure propagates: it must never turn N processes into N independent
    full runs racing on the output.
    """
    coord = os.environ.get(COORDINATOR_ENV)
    if not coord:
        # torchrun's environment: attempted only when it advertises
        # several workers; a missing RANK/MASTER_* raises in env://
        if int(os.environ.get("WORLD_SIZE") or 1) <= 1:
            return False
        if not dist.is_initialized():
            dist.init_process_group("gloo", init_method="env://")
        return True
    n_s = os.environ.get(NUM_PROCESSES_ENV)
    pid_s = os.environ.get(PROCESS_ID_ENV)
    if n_s is None or pid_s is None:
        raise SystemExit(
            "ERROR: %s is set but %s is missing "
            "(a multi-process launch needs %s, %s and %s in every "
            "process)."
            % (
                COORDINATOR_ENV,
                NUM_PROCESSES_ENV if n_s is None else PROCESS_ID_ENV,
                COORDINATOR_ENV,
                NUM_PROCESSES_ENV,
                PROCESS_ID_ENV,
            )
        )
    n = int(n_s)
    pid = int(pid_s)
    if not 0 <= pid < n:
        raise SystemExit(
            "ERROR: %s %d outside [0, %d)." % (PROCESS_ID_ENV, pid, n)
        )
    if dist.is_initialized():
        if dist.get_world_size() != n or dist.get_rank() != pid:
            raise RuntimeError(
                "a process group of %d ranks (this one %d) exists; the "
                "environment asks for %d (this one %d)"
                % (dist.get_world_size(), dist.get_rank(), n, pid)
            )
        return True
    dist.init_process_group(
        "gloo", init_method="tcp://" + coord, world_size=n, rank=pid
    )
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _allgather(arr: np.ndarray) -> np.ndarray:
    """Every process's ``arr`` (same shape and dtype on each), stacked
    ``[P, ...]`` in rank order.  Moved as bytes, so any dtype crosses."""
    arr = np.ascontiguousarray(arr)
    t = torch.from_numpy(arr.reshape(-1).view(np.uint8).copy())
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t)
    return np.stack([o.numpy().view(arr.dtype).reshape(arr.shape)
                     for o in out])


def shard_paths(paths: Sequence[str]) -> List[str]:
    """This process's round-robin shard of the input files."""
    return list(paths)[process_index() :: process_count()]


def merge_states_across_hosts(state, s: int):
    """Exact cross-process merge of per-process bottom-s states.

    All-gathers the small states and folds them on the state's device;
    every process ends with the same global state (the fold is
    order-free).
    """
    if process_count() == 1:
        return state
    from mash_tpu_torch.ops import sketch_ops

    dev = state[0].device
    gh = _allgather(state[0].cpu().numpy())
    gc = _allgather(state[1].cpu().numpy())
    return sketch_ops.tree_merge(
        torch.from_numpy(gh).to(dev), torch.from_numpy(gc).to(dev), s=s
    )


def sum_counts_across_hosts(counts: np.ndarray) -> np.ndarray:
    """Sum per-process screen count vectors (host numpy in and out).

    The sum can exceed the per-process dtype even though each shard fits,
    so it runs in 64 bits and SATURATES at the dtype's max rather than
    wrapping, as ``mash_tpu`` does (for uint32 counts: 2^32-1, so a sum
    can exceed one process's 2^31-1 big-DB limit).
    """
    if process_count() == 1:
        return counts
    tot = _allgather(counts).astype(np.uint64).sum(axis=0)
    lim = np.uint64(np.iinfo(counts.dtype).max)
    return np.minimum(tot, lim).astype(counts.dtype)


def reduce_meta_across_hosts(count: int, total_len: int,
                             skipped: bool) -> tuple:
    """Sum record-count metadata for pooled (reads-mode) sketching."""
    if process_count() == 1:
        return count, total_len, skipped
    tot = _allgather(
        np.array([count, total_len, int(skipped)], dtype=np.int64)
    ).sum(axis=0)
    return int(tot[0]), int(tot[1]), bool(tot[2])


def local_device_count(device=None) -> int:
    """Devices this process drives: every visible GPU when it runs on
    CUDA, else 1 (the CPU)."""
    from mash_tpu_torch.utils import resolve_device

    if resolve_device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def local_device_counts(device=None) -> np.ndarray:
    """Every process's :func:`local_device_count` (all-gathered).

    Stripe geometry (``distance.stream_pair_stripes``' ``row_block``)
    must be the same in every process, so it is derived from all
    processes' device counts, not the local one.
    """
    n = np.array([local_device_count(device)], dtype=np.int64)
    if process_count() == 1:
        return n
    return _allgather(n).reshape(-1)


def elect_min_with_payload(key0: int, key1: int,
                           payload: bytes) -> bytes:
    """Global argmin over ``(key0, key1)`` with a bytes payload.

    Every process contributes a candidate (``key0 < 0`` means "no
    candidate"); all return the payload of the lexicographically smallest
    key pair, ties broken by process index.  Elects the globally-first
    valid input record for reads-mode naming (the reference names the
    pooled sketch after the first record of the round-robin walk over
    all files, ``Sketch.cpp:1200-1270``).  Returns ``b""`` when no
    process has a candidate.
    """
    if process_count() == 1:
        return payload if key0 >= 0 else b""
    INF = np.int64(2**62)
    gk = _allgather(np.array(
        [INF if key0 < 0 else key0, key1, len(payload)], dtype=np.int64))
    # size the payload buffer to the global maximum so nothing is
    # truncated (headers have no length limit)
    max_len = max(int(gk[:, 2].max()), 1)
    buf = np.zeros(max_len, dtype=np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    gp = _allgather(buf)
    w = int(np.lexsort((np.arange(gk.shape[0]), gk[:, 1], gk[:, 0]))[0])
    if gk[w, 0] >= INF:
        return b""
    return gp[w, : int(gk[w, 2])].tobytes()


def owns_stripe(i0: int, row_block: int) -> bool:
    """Static round-robin stripe ownership for triangle/dist output."""
    return (i0 // row_block) % process_count() == process_index()


def max_across_hosts(x: float) -> float:
    """Global max of a per-process scalar (triangle's peak p-value)."""
    if process_count() == 1:
        return x
    return float(_allgather(np.array([x], dtype=np.float64)).max())
