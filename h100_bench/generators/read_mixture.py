"""A sequenced mixture and the sketch DB it is screened against.

Traffic keys: ``present`` and ``absent``, the genomes whose reads make up
the mixture, the first in the DB and the second not; ``genome_mbase``
[lo, hi], their log-uniform lengths (one record each);
``present_share``, the share of reads from present genomes; each genome's
share within its group follows log-normal abundances with
``abundance_sigma``; ``read_len``, ``substitution_rate`` and ``n_rate``
of the reads, every other strand reverse-complemented at random;
``parts`` x ``reads_per_part`` reads, each part one FASTQ input.

The DB is the configuration's, since its scale is the deployment's:
``db_sketches`` sketches, the present genomes' and random ones, each
``sketch_size`` distinct hashes below 2^64 * s / G for a genome length G
log-uniform in ``db_genome_mbase``, as the bottom s of G random hashes
lie.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from h100_bench import seqgen


@dataclass
class ReadMixture:
    present: list            # uint8 ASCII genome of each present genome
    absent: list
    reads: np.ndarray        # uint8 ASCII [parts * reads_per_part, read_len]
    parts: int
    reads_per_part: int
    random_db: np.ndarray    # uint64 [db_sketches - present, s], rows sorted
    present_slots: np.ndarray  # ascending DB positions of the present
    line_width: int = 80

    def part_reads(self, p: int) -> np.ndarray:
        r = self.reads_per_part
        return self.reads[p * r:(p + 1) * r]

    def part_bases(self, p: int) -> int:
        return int(self.part_reads(p).size)

    def part_windows(self, p: int, k: int) -> int:
        reads = self.part_reads(p)
        n = reads.shape[0] * max(0, reads.shape[1] - k + 1)
        return max(0, n - k * int((reads == ord("N")).sum()))

    def fasta(self, i: int) -> bytes:
        return seqgen.fasta([(b"present%d synthetic genome" % i,
                              self.present[i])], self.line_width)

    def fastq(self, p: int) -> bytes:
        return seqgen.fastq(self.part_reads(p), p * self.reads_per_part)


def _genome_lengths(traffic, n, gen):
    lo, hi = traffic["genome_mbase"]
    sizes = np.round(seqgen.log_uniform_quantiles(lo * 1e6, hi * 1e6, n))
    return seqgen.permuted(sizes.astype(np.int64), gen)


def _reads(codes, starts_of, lens, counts, traffic, gen):
    """Reads drawn from the genomes in ``codes`` (concatenated, genome g
    at ``starts_of[g]``), ``counts[g]`` of genome g, in random order."""
    dev = gen.device
    L = traffic["read_len"]
    gid = torch.repeat_interleave(torch.arange(len(counts), device=dev),
                                  torch.as_tensor(counts, device=dev))
    gid = gid[torch.randperm(gid.numel(), generator=gen, device=dev)]
    span = torch.as_tensor(lens - L + 1, device=dev)[gid]
    off = (torch.rand(gid.numel(), generator=gen, device=dev,
                      dtype=torch.float64) * span).long()
    start = torch.as_tensor(starts_of, device=dev)[gid] + off
    reads = codes[start[:, None] + torch.arange(L, device=dev)]
    sub = torch.rand(reads.shape, generator=gen, device=dev) \
        < traffic["substitution_rate"]
    shift = torch.randint(1, 4, reads.shape, generator=gen, device=dev,
                          dtype=torch.uint8)
    reads = torch.where(sub & (reads < 4), (reads + shift) % 4, reads)
    flip = torch.rand(reads.shape[0], generator=gen, device=dev) < 0.5
    rc = torch.where(reads < 4, 3 - reads, reads).flip(1)
    reads = torch.where(flip[:, None], rc, reads)
    n_n = int(round(reads.numel() * traffic["n_rate"]))
    if n_n:
        pos = torch.randint(0, reads.numel(), (n_n,), generator=gen,
                            device=dev)
        reads.view(-1)[pos] = 4
    return seqgen.to_ascii(reads)


def _random_db(config, n, gen):
    """``n`` sketches of ``s`` distinct random hashes, each below
    2^64 * s / G for its genome length G."""
    s = config["sketch_size"]
    lo, hi = config["db_genome_mbase"]
    g = seqgen.permuted(seqgen.log_uniform_quantiles(lo * 1e6, hi * 1e6, n),
                        gen)
    top = torch.as_tensor(np.minimum(2.0 ** 64 * s / g, 2.0 ** 62),
                          device=gen.device).long()[:, None]
    x = torch.randint(0, 2 ** 62, (n, s), generator=gen, device=gen.device)
    rows = torch.sort(x % top, dim=1).values
    while True:
        dup = (rows[:, 1:] == rows[:, :-1]).any(dim=1).nonzero().squeeze(1)
        if not dup.numel():
            break
        x = torch.randint(0, 2 ** 62, (dup.numel(), s), generator=gen,
                          device=gen.device)
        rows[dup] = torch.sort(x % top[dup], dim=1).values
    return rows.cpu().numpy().view(np.uint64)


def generate(config: dict, traffic: dict, seed: int, device) -> ReadMixture:
    gen = seqgen.generator(seed, device)
    n_p, n_a = traffic["present"], traffic["absent"]
    lens = np.concatenate([_genome_lengths(traffic, n_p, gen),
                           _genome_lengths(traffic, n_a, gen)])
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    codes = seqgen.random_codes(int(lens.sum()), traffic["n_rate"], gen)
    share = traffic["present_share"]
    sigma = traffic["abundance_sigma"]
    weights = np.concatenate([
        share * _norm(seqgen.permuted(seqgen.lognormal_quantiles(sigma, n_p),
                                      gen)),
        (1 - share) * _norm(seqgen.permuted(
            seqgen.lognormal_quantiles(sigma, n_a), gen))])
    n_reads = traffic["parts"] * traffic["reads_per_part"]
    counts = seqgen.shares(weights, n_reads)
    reads = _reads(codes, starts, lens, counts, traffic, gen)
    ascii = seqgen.to_ascii(codes)
    genomes = [ascii[a:a + n] for a, n in zip(starts, lens)]
    del codes
    n_db = config["db_sketches"]
    slots = torch.randperm(n_db, generator=gen, device=gen.device)[:n_p]
    return ReadMixture(
        present=genomes[:n_p], absent=genomes[n_p:], reads=reads,
        parts=traffic["parts"], reads_per_part=traffic["reads_per_part"],
        random_db=_random_db(config, n_db - n_p, gen),
        present_slots=np.sort(slots.cpu().numpy()))


def _norm(w):
    return w / w.sum()
