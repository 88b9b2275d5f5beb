"""Bottom-s MinHash selection as sort/fold programs on tensors.

The counterpart of ``mash_tpu.ops.sketch_ops``.  The reference keeps the
s smallest *distinct* k-mer hashes (with multiplicities) in a heap +
hash map (``src/mash/MinHashHeap.cpp:68-146``).  Selecting the bottom s
distinct values is associative and commutative, so here it becomes:

  per chunk:     sort -> run-detect -> first s distinct (+ summed counts)
  across chunks: fold the states as sorted segments of one row

Counts are total occurrence counts of each surviving hash
(order-independent), exactly as in ``mash_tpu``.  The fold of sorted
rows and segments is ``ops.fold_kernel.fold_sorted``: the kernel K6 on a
CUDA tensor, the plain sort and scatter on a CPU tensor.  Bytes become
per-row states through one route on every device,
``sketch_kernel.sketch_chunks_deferred`` (K1's candidates, K6's fold and
the deferred certificate below); :func:`sketch_chunk` is its full sort,
for the rows that lack the certificate and for short rows.

State representation: ``(hashes[s], counts[s])``, both int64.  Hashes
are uint64 bit patterns sorted in *unsigned* order; empty slots have
``counts == 0`` and hash ``EMPTY`` (2^64-1, i.e. int64 -1).  A real hash
equal to EMPTY is still tracked correctly because emptiness is defined
by ``counts == 0``.
"""

from __future__ import annotations

import numpy as np
import torch

from mash_tpu_torch.ops.fold_kernel import (
    EMPTY,
    biased,  # noqa: F401  (other modules import it from here)
    fold_sorted,
    sort_unsigned,
)
from mash_tpu_torch.utils.profiling import count, stage


def empty_state(s: int, device="cpu"):
    """An empty bottom-s sketch state."""
    return (
        torch.full((s,), EMPTY, dtype=torch.int64, device=device),
        torch.zeros((s,), dtype=torch.int64, device=device),
    )


def sketch_chunk(hashes: torch.Tensor, valid: torch.Tensor, *, s: int):
    """Bottom-s distinct hashes (+occurrence counts) of hashed chunks.

    Args:
      hashes: int64 ``[..., n]`` window hashes (``ops.kmers.hash_chunk``).
      valid: bool ``[..., n]`` window validity mask.
      s: sketch size.
    """
    h = torch.where(valid, hashes, torch.full_like(hashes, EMPTY))
    h, c = sort_unsigned(h, valid.long())
    return fold_sorted(h, c, s)


def candidate_budget(s: int, C: int, n: int) -> int:
    """Per-subrow candidate budget m for hierarchical bottom-s selection.

    With uniform hashes, a C-wide subrow of an n-window chunk holds
    Poisson(~1.2*s*C/n) of the globally relevant bottom hashes; a floor
    of 16 plus 6 lambdas of headroom makes an overflow (-> verified
    fallback) vanishingly rare while keeping the per-subrow selection
    tiny.  The budget of K1 (``sketch_kernel.sketch_chunks_deferred``).
    """
    lam = max(1.0, 1.2 * s * C / n)
    m = 16
    while m < 6 * lam:
        m *= 2
    return m


def merge_states(state_a, state_b, *, s: int):
    """Merge two bottom-s states of one width (associative +
    commutative): two sorted segments of one row."""
    if state_a[0].shape != state_b[0].shape:
        raise ValueError("merge_states takes two states of one width")
    h = torch.cat([state_a[0], state_b[0]])
    c = torch.cat([state_a[1], state_b[1]])
    return fold_sorted(h, c, s, segments=2)


def tree_merge(states_h: torch.Tensor, states_c: torch.Tensor, *, s: int):
    """Merge ``[B, w]`` stacked states into one state: one row of ``B``
    sorted segments."""
    return fold_sorted(states_h.reshape(-1), states_c.reshape(-1), s,
                       segments=states_h.numel() // states_h.shape[-1])


# -- the deferred certificate ----------------------------------------------
#
# A batch's rows whose certificate fails on the device are emptied there
# (``fold_kernel.empty_rows``) and folded in as they are; their exact
# states are merged in later, once the mask of those rows has reached
# the host.
# This is exact because the bottom-s merge with summed counts is
# associative and commutative, so the order of the merges does not
# matter, and because a hash the state drops can never return: it was
# dropped because s smaller distinct hashes were in the state, and a
# state only gains hashes.  Each row's own state is its exact bottom s,
# and a hash of the final bottom s has fewer than s smaller ones in any
# row, so every row that holds it counted it.


class Uncertified:
    """Rows of one batch that lack the certificate, to be recomputed.

    ``rows`` is the device batch (what the kernel saw), ``bad`` its
    device bool mask of rows to recompute, ``recompute(rows)`` the full
    sort to their ``[b, s]`` states.  The mask's copy to the host starts
    here (:class:`~mash_tpu_torch.utils.transfer.Readback`), so it is
    queued before any later batch's work.
    """

    def __init__(self, rows: torch.Tensor, bad: torch.Tensor, recompute):
        from mash_tpu_torch.utils.transfer import Readback

        self.rows = rows
        self.mask = Readback(bad)
        self.recompute = recompute

    def states(self):
        """``(index, H [b, s], C [b, s])`` of the rows without the
        certificate, on their device, ``index`` their device positions in
        the batch; None when every row has it.  Waits for the mask's copy
        alone."""
        idx = np.flatnonzero(self.mask.numpy())
        count("sketch:rows_recomputed", idx.size)
        if not idx.size:
            return None
        sel = torch.from_numpy(idx).to(self.rows.device, non_blocking=True)
        return (sel, *self.recompute(self.rows.index_select(0, sel)))


def merge_uncertified(state, pending):
    """``state`` with the exact states of every :class:`Uncertified` in
    ``pending`` merged in."""
    h, c = state
    for p in pending:
        got = p.states()
        if got is None:
            continue
        _, ph, pc = got
        h, c = tree_merge(
            torch.cat([h[None], ph.to(h.device, non_blocking=True)]),
            torch.cat([c[None], pc.to(c.device, non_blocking=True)]),
            s=h.shape[-1],
        )
    return h, c


class PendingState:
    """A bottom-s state ``(H, C)`` whose last batch still has rows that
    lack the certificate (:class:`Uncertified`).

    Reading it (``state[0]``, ``h, c = state``) settles it first: it
    waits for those rows' masks, merges their exact states in and keeps
    the result, so no reader sees an unsettled state.  :func:`fold_batch`
    alone reads ``raw`` and ``pending``, to settle them one batch later.
    """

    def __init__(self, h: torch.Tensor, c: torch.Tensor, pending):
        self.raw = (h, c)
        self.pending = list(pending)
        self._settled = None

    def settled(self) -> bool:
        return self._settled is not None

    def settle(self):
        if self._settled is None:
            self._settled = merge_uncertified(self.raw, self.pending)
        return self._settled

    def __getitem__(self, i):
        return self.settle()[i]

    def __iter__(self):
        return iter(self.settle())

    def __len__(self) -> int:
        return 2


def fold_batch(state, sh: torch.Tensor, sc: torch.Tensor, pending=(), *,
               s: int):
    """Fold a batch's ``[B, s]`` row states into ``state``.

    When ``state`` is a :class:`PendingState`, its last batch is settled
    only after this batch's merge has been queued, so the card has this
    batch to run while the host waits for the earlier mask (the stage
    ``engine:settle``, with that wait in it).  ``pending``
    holds this batch's :class:`Uncertified` rows (None entries are
    skipped); the result is a :class:`PendingState` when any remain,
    else a plain ``(H, C)``.  No step reads the device.
    """
    count("sketch:rows_folded", sh.shape[0])
    if isinstance(state, PendingState) and not state.settled():
        base, prev = state.raw, state.pending
    else:
        base, prev = tuple(state), ()
    new = tree_merge(torch.cat([base[0][None], sh]),
                     torch.cat([base[1][None], sc]), s=s)
    if prev:
        with stage("engine:settle"):
            new = merge_uncertified(new, prev)
    pending = [p for p in pending if p is not None]
    return PendingState(*new, pending) if pending else new


def state_stats(state):
    """(size, max_hash, multiplicity_sum) of a state, as host scalars.

    Mirrors the quantities behind the reference's estimators
    (``MinHashHeap.h:44-45``): ``size`` = heap fill, ``max_hash`` = heap
    top (as an unsigned int), ``multiplicity_sum`` = sum of counts.
    """
    h, c = state
    size = int((c > 0).sum())
    if size == 0:
        return 0, 0, 0
    mx = int(h[size - 1]) & ((1 << 64) - 1)
    msum = int(c.sum())
    return size, mx, msum


def estimate_set_size(state, use64: bool = True) -> float:
    """Distinct-element cardinality estimate (``MinHashHeap.h:45``)."""
    size, mx, _ = state_stats(state)
    if size == 0:
        return 0.0
    bits = 64.0 if use64 else 32.0
    return (2.0 ** bits) * size / float(mx)


def estimate_multiplicity(state) -> float:
    """Average k-mer multiplicity estimate (``MinHashHeap.h:44``)."""
    size, _, msum = state_stats(state)
    if size == 0:
        return 0.0
    return msum / size
