"""Plain reference of the screen path: DB counts, the mixture's
cardinality sketch, and the report of ``mash screen``.

``mash screen`` (Ondov et al. 2019, ``CommandScreen.cpp``) counts, for
every distinct hash of the DB's sketches, the mixture's k-mer windows that
give it (uint32 counts); keeps the mixture's bottom-s sketch for its
cardinality, ``2^bits * size / max``; and reports, for each DB sketch
that shares a hash: the shared count, identity ``(shared/s)^(1/k)``, the
median multiplicity of the shared hashes (``depths[shared / 2]`` of the
sorted counts) and the p-value, the binomial tail of ``shared`` in ``s``
at ``cardinality / 4^k``.

The reference recomputes the DB itself: the random sketches are the
harness's data, and it sketches the present genomes from their sequences
(:mod:`h100_bench.reference.sketch`).  A window that streamed ``units``
parts went ``units // P`` times round the pool of P parts and then
through its first ``units % P``; every count and the sketch are sums over
parts, so the reference weighs each part's once.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import bdtrc

from h100_bench.outcome import Outcome
from h100_bench.reference.kmers import biased, unsigned, window_hashes
from h100_bench.reference.sketch import genome_sketch

# db_counts_wrong, mixture_state_wrong and report_wrong count wrong
# answers: exact, limit 0.  report_gap is the largest relative gap of an
# identity or p-value; its limit lies between the program's readings
# (lower) and the control's (upper), PERF.md gives both.
LIMITS = {
    "db_counts_wrong": 0,
    "mixture_state_wrong": 0,
    "report_wrong": 0,
    "report_gap": 1e-9,
}


def db_lists(config, data, device, bits=None):
    """The DB's sketches in DB order: the data's random ones, and the
    present genomes' at their slots."""
    rows = [r for r in data.random_db]
    for j, slot in enumerate(data.present_slots):
        h, _ = genome_sketch([data.present[j]], config, device, bits)
        rows.insert(int(slot), h)
    return rows


def reference_outcome(config, traffic, data, units: int, device,
                      bits: int | None = None) -> Outcome:
    """What a sound program answers after streaming ``units`` parts."""
    k, s, seed = config["kmer_size"], config["sketch_size"], config["hash_seed"]
    bits = config["hash_bits"] if bits is None else bits
    rows = db_lists(config, data, device, bits)
    sizes = torch.tensor([len(r) for r in rows], device=device)
    entries = biased(torch.from_numpy(
        np.concatenate(rows).view(np.int64)).to(device))
    ref_of = torch.repeat_interleave(
        torch.arange(len(rows), device=device), sizes)
    db = torch.unique(entries, sorted=True)
    H = db.numel()

    P = data.parts
    rounds, extra = divmod(units, P)
    totals = torch.zeros(H, dtype=torch.int64, device=device)
    keep_h, keep_c = [], []
    for p in range(P):
        w = rounds + (1 if p < extra else 0)
        if w == 0:
            continue
        reads = torch.from_numpy(data.part_reads(p)).to(device)
        h, v = window_hashes(reads, k, seed, bits)
        del reads
        u, c = torch.unique(biased(h[v]), sorted=True, return_counts=True)
        del h, v
        pos = torch.searchsorted(db, u).clamp_(max=H - 1)
        hit = db[pos] == u
        totals.index_add_(0, pos[hit], c[hit] * w)
        keep_h.append(u[:s])
        keep_c.append(c[:s] * w)
    u, inv = torch.unique(torch.cat(keep_h), sorted=True, return_inverse=True)
    c = torch.zeros(u.numel(), dtype=torch.int64, device=device)
    c.index_add_(0, inv, torch.cat(keep_c))
    state_h, state_c = biased(u[:s]), c[:s]
    counts = totals & 0xFFFFFFFF  # Mash's uint32 counts

    size = state_h.numel()
    top = unsigned(int(state_h[-1])) if size else 0
    set_size = int(2.0 ** bits * size / float(top)) if size else 0

    cnt = counts[torch.searchsorted(db, entries)]
    hit = cnt >= 1
    shared = torch.bincount(ref_of[hit], minlength=len(rows))
    key = torch.sort((ref_of[hit] << 32) | cnt[hit]).values
    starts = torch.cumsum(shared, 0) - shared
    idx = torch.nonzero(shared).squeeze(1)
    median = key[starts[idx] + shared[idx] // 2] & 0xFFFFFFFF
    idx, sh = idx.cpu().numpy(), shared[idx].cpu().numpy()
    n = sizes.cpu().numpy()[idx]
    kmer_space = 4.0 ** k
    identity = np.array([_identity(int(a), int(b), k) for a, b in zip(sh, n)])
    pvalue = bdtrc(sh - 1, n, set_size / kmer_space) if len(sh) else sh * 0.0
    return Outcome(
        units=units, bases=0, windows=0,
        answers={
            "db_hashes": biased(db).cpu().numpy().view(np.uint64),
            "counts": counts.cpu().numpy().astype(np.uint32),
            "state_h": state_h.cpu().numpy().view(np.uint64),
            "state_c": state_c.cpu().numpy(),
            "set_size": set_size,
            "report": {"ref": idx, "shared": sh,
                       "median": median.cpu().numpy(),
                       "identity": identity, "pvalue": np.asarray(pvalue)},
        })


def _identity(shared: int, size: int, k: int) -> float:
    if size == 0 or shared == 0:
        return 0.0
    if shared == size:
        return 1.0
    return math.pow(shared / size, 1.0 / k)


def expected(config, traffic, data, outcome, device) -> Outcome:
    return reference_outcome(config, traffic, data, outcome.units, device)


def control_outcome(config, traffic, data, device) -> Outcome:
    """The control: the reference in the program's place at half the
    hash width, one pass over the pool."""
    return reference_outcome(config, traffic, data, data.parts, device,
                             bits=config["hash_bits"] // 2)


def judge(outcome, want) -> dict:
    got, ref = outcome.answers, want.answers
    return {
        "db_counts_wrong": _map_wrong(got["db_hashes"], got["counts"],
                                      ref["db_hashes"], ref["counts"]),
        "mixture_state_wrong": _rows_wrong(
            (got["state_h"], got["state_c"]), (ref["state_h"], ref["state_c"])),
        "report_wrong": _report_wrong(got, ref),
        "report_gap": _report_gap(got["report"], ref["report"]),
    }


def failed(found: dict, outcome, correct: bool) -> int:
    """Units whose answer was wrong: every part streamed, where the
    counts or the report that sums them are wrong."""
    return 0 if correct else outcome.units


def _map_wrong(keys_a, vals_a, keys_b, vals_b) -> int:
    """Keys held by one side only, plus common keys whose values differ."""
    keys_a = np.asarray(keys_a, np.uint64)
    keys_b = np.asarray(keys_b, np.uint64)
    common, ia, ib = np.intersect1d(keys_a, keys_b, assume_unique=True,
                                    return_indices=True)
    only = len(keys_a) + len(keys_b) - 2 * len(common)
    diff = np.asarray(vals_a)[ia].astype(np.int64) \
        != np.asarray(vals_b)[ib].astype(np.int64)
    return int(only + diff.sum())


def _rows_wrong(a, b) -> int:
    """Positions of two sorted ``(hash, count)`` lists that differ."""
    n = min(len(a[0]), len(b[0]))
    diff = (np.asarray(a[0][:n], np.uint64) != np.asarray(b[0][:n], np.uint64)) \
        | (np.asarray(a[1][:n], np.int64) != np.asarray(b[1][:n], np.int64))
    return int(diff.sum()) + abs(len(a[0]) - len(b[0]))


def _report_wrong(got, ref) -> int:
    """Report rows on one side only or whose shared count or median
    multiplicity differ, plus 1 if the cardinality differs."""
    g, r = got["report"], ref["report"]
    wrong = int(got["set_size"] != ref["set_size"])
    common, ig, ir = np.intersect1d(g["ref"], r["ref"], assume_unique=True,
                                    return_indices=True)
    wrong += len(g["ref"]) + len(r["ref"]) - 2 * len(common)
    wrong += int(((np.asarray(g["shared"])[ig] != np.asarray(r["shared"])[ir])
                  | (np.asarray(g["median"])[ig]
                     != np.asarray(r["median"])[ir])).sum())
    return wrong


def _report_gap(g, r) -> float:
    """Largest relative gap of an identity or p-value over the rows both
    sides report."""
    _, ig, ir = np.intersect1d(g["ref"], r["ref"], assume_unique=True,
                               return_indices=True)
    gap = 0.0
    for f in ("identity", "pvalue"):
        a = np.asarray(g[f], np.float64)[ig]
        b = np.asarray(r[f], np.float64)[ir]
        scale = np.maximum(np.abs(a), np.abs(b))
        with np.errstate(invalid="ignore", divide="ignore"):
            rel = np.where(scale > 0, np.abs(a - b) / scale, 0.0)
        if rel.size:
            gap = max(gap, float(rel.max()))
    return gap
