"""A pool of genome assemblies, each sketched as one FASTA file.

Traffic keys: ``genomes`` (pool size); ``genome_mbase`` [lo, hi], the
log-uniform range of genome lengths; ``layout``: ``replicons`` (a
chromosome and ``records`` - 1 plasmids of ``plasmid_kbase``, log-uniform)
or ``contigs`` (``records`` [lo, hi] log-uniform contigs a genome, of
log-normal lengths with ``contig_sigma``, none under ``min_contig``);
``n_rate``, the share of N bases; ``line_width`` of the FASTA text.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from h100_bench import seqgen


@dataclass
class GenomePool:
    genomes: list          # per genome, its records: uint8 ASCII arrays
    line_width: int

    def lengths(self) -> np.ndarray:
        return np.array([sum(len(r) for r in g) for g in self.genomes],
                        np.int64)

    def fasta(self, i: int) -> bytes:
        return seqgen.fasta(
            [(b"g%d_r%d synthetic assembly" % (i, j), rec)
             for j, rec in enumerate(self.genomes[i])], self.line_width)

    def windows(self, i: int, k: int) -> int:
        return sum(seqgen.n_free_windows(r, k) for r in self.genomes[i])


def record_lengths(traffic: dict, gen: torch.Generator) -> list:
    """Each genome's record lengths, in an order drawn from ``gen``: the
    genomes themselves are the same for every seed."""
    n = traffic["genomes"]
    lo, hi = traffic["genome_mbase"]
    sizes = np.round(seqgen.log_uniform_quantiles(lo * 1e6, hi * 1e6, n))
    rlo, rhi = traffic["records"]
    out = []
    if traffic["layout"] == "replicons":
        counts = rlo + np.arange(n) % (rhi - rlo + 1)
        plo, phi = traffic["plasmid_kbase"]
        plasmids = list(np.round(seqgen.log_uniform_quantiles(
            plo * 1e3, phi * 1e3, int((counts - 1).sum()))).astype(np.int64))
        for size, c in zip(sizes, counts):
            rest = [int(plasmids.pop()) for _ in range(c - 1)]
            out.append([int(size) - sum(rest)] + rest)
    elif traffic["layout"] == "contigs":
        # the larger a MAG, the more contigs it comes in
        counts = np.round(seqgen.log_uniform_quantiles(rlo, rhi, n))
        for size, c in zip(sizes, counts):
            w = seqgen.lognormal_quantiles(traffic["contig_sigma"], int(c))
            lens = np.maximum(np.round(w / w.sum() * size),
                              traffic["min_contig"]).astype(np.int64)
            out.append(sorted(lens.tolist(), reverse=True))
    else:
        raise ValueError("unknown layout %r" % traffic["layout"])
    return [out[i] for i in seqgen.permuted(np.arange(n), gen)]


def generate(config: dict, traffic: dict, seed: int, device) -> GenomePool:
    gen = seqgen.generator(seed, device)
    lens = record_lengths(traffic, gen)
    flat = np.array([x for g in lens for x in g], np.int64)
    seq = seqgen.to_ascii(seqgen.random_codes(int(flat.sum()),
                                              traffic["n_rate"], gen))
    recs = np.split(seq, np.cumsum(flat)[:-1])
    genomes, i = [], 0
    for g in lens:
        genomes.append(recs[i:i + len(g)])
        i += len(g)
    return GenomePool(genomes, traffic["line_width"])
