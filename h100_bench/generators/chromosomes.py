"""One reference assembly at its published record lengths, gapped with
runs of N and soft-masked, sketched as one FASTA file.

The configuration gives the records (``records``: name and length), the
runs of N (``n_end_bases`` at both ends of each nuclear chromosome,
``n_arms`` at the start of the acrocentric ones, ``n_blocks`` inside
theirs, and ``n_runs`` interior runs log-uniform in ``n_run_bases``
that bring the N to ``n_total_bases``; chrM has none) and the soft mask
(upper- and lower-case runs in turn, log-uniform in ``mask_run_bases``).
Traffic keys: ``line_width`` of the FASTA text; ``genome_mbase``
[lo, hi], absent from a cell's own traffic, scales every length of
the layout but the mask's runs so that the assembly is hi Mbase, for
short runs on the CPU.

Sizes are fixed: a seed draws the bases, the order of the interior runs
and so the chromosome each lands on, the positions of the runs of N
(all but the arms) and the order of the mask's runs.  It never changes
a record's length or the total of N.  The bases are drawn one record at
a time on the run's device, so no tensor holds more than one
chromosome.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from h100_bench import seqgen

MITO = "chrM"


@dataclass
class Assembly:
    genomes: list      # the one genome: its records, uint8 ASCII arrays
    names: list        # the records' names
    free_runs: list    # per record, the lengths of its runs without N
    line_width: int

    def lengths(self) -> np.ndarray:
        return np.array([sum(len(r) for r in g) for g in self.genomes],
                        np.int64)

    def fasta(self, i: int) -> bytes:
        return seqgen.fasta([(n.encode(), r) for n, r
                             in zip(self.names, self.genomes[i])],
                            self.line_width)

    def windows(self, i: int, k: int) -> int:
        """The genome's k-mer windows that no N touches, exactly: each
        run without N of length r holds r - k + 1 of them."""
        return int(sum(np.maximum(runs - k + 1, 0).sum()
                       for runs in self.free_runs))


def scale_of(config: dict, traffic: dict) -> float:
    if "genome_mbase" not in traffic:
        return 1.0
    return traffic["genome_mbase"][1] * 1e6 / config["total_bases"]


def layout(config: dict, f: float = 1.0):
    """``(nuclear, lengths, ends, arms, blocks, runs)``, scaled by ``f``:
    whether each record is a nuclear chromosome, its length, its N at
    each end, its arm and its blocks, and the interior runs of N in
    their fixed order."""
    names = [n for n, _ in config["records"]]
    lengths = np.array([max(1, round(x * f)) for _, x in config["records"]],
                       np.int64)
    nuclear = np.array([n != MITO for n in names])
    ends = np.where(nuclear, round(config["n_end_bases"] * f), 0)
    arms = np.zeros(len(names), np.int64)
    for n, x in config["n_arms"]:
        arms[names.index(n)] = round(x * f)
    blocks = [[] for _ in names]
    for n, x in config["n_blocks"]:
        blocks[names.index(n)].append(round(x * f))
    lo, hi = config["n_run_bases"]
    rest = round(f * (config["n_total_bases"]
                      - config["n_end_bases"] * 2 * int(nuclear.sum())
                      - sum(x for _, x in config["n_arms"])
                      - sum(x for _, x in config["n_blocks"])))
    runs = seqgen.shares(seqgen.log_uniform_quantiles(lo, hi,
                                                      config["n_runs"]),
                         rest)
    return nuclear, lengths, ends, arms, blocks, runs


def record_gaps(config: dict, traffic: dict, gen: torch.Generator):
    """Per record, ``(length, gaps)``: ``gaps`` the ``(start, end)`` of
    its runs of N, in order and apart, drawn from ``gen``."""
    nuclear, lengths, ends, arms, blocks, runs = layout(
        config, scale_of(config, traffic))
    # the interior runs, in an order drawn from the seed, dealt to the
    # nuclear chromosomes in proportion to their lengths
    dealt = seqgen.shares(np.where(nuclear, lengths, 0), len(runs))
    order = list(seqgen.permuted(runs, gen))
    out = []
    for r, length in enumerate(lengths):
        inner = blocks[r] + [int(order.pop()) for _ in range(dealt[r])]
        inner = [int(x) for x in seqgen.permuted(inner, gen)] if inner \
            else []
        free = int(length - 2 * ends[r] - arms[r] - sum(inner))
        if free < 0:
            raise ValueError("record %d holds more N than bases" % r)
        # the free bases split into len(inner) + 1 spacers at cut points
        # drawn from the seed
        cuts = torch.randint(0, free + 1, (len(inner),), generator=gen,
                             device=gen.device)
        cuts = np.sort(cuts.cpu().numpy().astype(np.int64))
        spacers = np.diff(np.concatenate([[0], cuts, [free]]))
        gaps, at = [], int(ends[r])
        if ends[r]:
            gaps.append((0, at))
        if arms[r]:
            gaps.append((at, at + int(arms[r])))
            at += int(arms[r])
        for sp, g in zip(spacers, inner):
            at += int(sp)
            gaps.append((at, at + g))
            at += g
        at += int(spacers[-1])
        if ends[r]:
            gaps.append((at, at + int(ends[r])))
            at += int(ends[r])
        assert at == length
        out.append((int(length), [(a, b) for a, b in gaps if b > a]))
    return out


def free_runs(length: int, gaps) -> np.ndarray:
    """Lengths of the runs between the gaps (and the record's ends)."""
    edges = np.array([0] + [x for g in gaps for x in g] + [length],
                     np.int64).reshape(-1, 2)
    return edges[:, 1] - edges[:, 0]


def soft_mask(length: int, config: dict, gen: torch.Generator):
    """Bool ``[length]`` on the generator's device: lower case in every
    other run of the mask, runs log-uniform in ``mask_run_bases`` in an
    order drawn from the seed."""
    lo, hi = config["mask_run_bases"]
    mean = (hi - lo) / np.log(hi / lo)
    n = int(length / mean * 1.25) + 4
    runs = seqgen.permuted(
        np.round(seqgen.log_uniform_quantiles(lo, hi, n)).astype(np.int64),
        gen)
    edges = np.cumsum(runs)
    edges = edges[: np.searchsorted(edges, length) + 1]
    edges[-1] = min(edges[-1], length)
    # runs 1, 3, 5, ... are lower case: +1 where one starts, -1 where it
    # ends
    starts, stops = edges[0:-1:2], edges[1::2]
    delta = torch.zeros(length + 1, dtype=torch.int8, device=gen.device)
    delta[torch.from_numpy(starts).to(gen.device)] = 1
    delta[torch.from_numpy(stops).to(gen.device)] -= 1
    return torch.cumsum(delta, 0, dtype=torch.int8)[:length].bool()


def generate(config: dict, traffic: dict, seed: int, device) -> Assembly:
    gen = seqgen.generator(seed, device)
    records, runs = [], []
    for length, gaps in record_gaps(config, traffic, gen):
        codes = torch.randint(0, 4, (length,), generator=gen,
                              device=gen.device, dtype=torch.uint8)
        for a, b in gaps:
            codes[a:b] = 4
        ascii = seqgen.ASCII.to(codes.device)[codes.int()]
        lower = soft_mask(length, config, gen) & (codes < 4)
        ascii |= lower.to(torch.uint8) << 5
        del codes, lower
        records.append(ascii.cpu().numpy())
        del ascii
        runs.append(free_runs(length, gaps))
    return Assembly([records], [n for n, _ in config["records"]], runs,
                    traffic["line_width"])
