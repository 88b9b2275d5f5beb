"""Synthetic sequences from a seed, and their FASTA and FASTQ text.

Sizes (genome, record and part lengths, read shares) are fixed quantiles
of the traffic's distributions, and a seed only permutes them and draws
the bases: every seed asks for the same work, in another order and on
other sequences, so that seeds differ no more than two runs of one seed.
Bulk random draws are made on the run's device with one
``torch.Generator``, in a few large calls.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np
import torch

# base codes: 0..3 for A, C, G, T; 4 for N
ASCII = torch.tensor(list(b"ACGTN"), dtype=torch.uint8)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def log_uniform_quantiles(lo: float, hi: float, n: int) -> np.ndarray:
    """The n mid-quantiles of a log-uniform distribution on [lo, hi]."""
    q = (np.arange(n) + 0.5) / n
    return np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))


def lognormal_quantiles(sigma: float, n: int) -> np.ndarray:
    """The n mid-quantiles of exp(N(0, sigma^2))."""
    nd = NormalDist()
    return np.exp(sigma * np.array([nd.inv_cdf((i + 0.5) / n)
                                    for i in range(n)]))


def permuted(values, gen: torch.Generator) -> np.ndarray:
    values = np.asarray(values)
    order = torch.randperm(len(values), generator=gen,
                           device=gen.device).cpu().numpy()
    return values[order]


def shares(weights, total: int) -> np.ndarray:
    """``total`` split in proportion to ``weights`` (largest remainder)."""
    w = np.asarray(weights, np.float64)
    exact = w / w.sum() * total
    out = np.floor(exact).astype(np.int64)
    rest = np.argsort(-(exact - out), kind="stable")[: total - out.sum()]
    out[rest] += 1
    return out


def random_codes(n: int, n_rate: float, gen: torch.Generator) -> torch.Tensor:
    """``n`` random bases as codes on the generator's device, with
    ``round(n * n_rate)`` of them N."""
    codes = torch.randint(0, 4, (n,), generator=gen, device=gen.device,
                          dtype=torch.uint8)
    n_n = int(round(n * n_rate))
    if n_n:
        pos = torch.randint(0, n, (n_n,), generator=gen, device=gen.device)
        codes[pos] = 4
    return codes


def to_ascii(codes: torch.Tensor) -> np.ndarray:
    return ASCII.to(codes.device)[codes.int()].cpu().numpy()


def fasta(records, width: int = 80) -> bytes:
    """FASTA text of ``(name, uint8 ASCII sequence)`` records, wrapped at
    ``width``."""
    out = []
    for name, seq in records:
        out.append(b">" + name + b"\n")
        full = len(seq) // width
        lines = np.full((full, width + 1), ord("\n"), np.uint8)
        lines[:, :width] = seq[: full * width].reshape(full, width)
        out.append(lines.tobytes())
        if len(seq) > full * width:
            out.append(seq[full * width:].tobytes() + b"\n")
    return b"".join(out)


def fastq(reads: np.ndarray, first: int) -> bytes:
    """FASTQ text of uint8 ASCII reads ``[N, L]``, named by number from
    ``first``, quality all 'I'."""
    n, L = reads.shape
    head = 11  # '@', 9 digits, '\n'
    rec = np.empty((n, head + L + 3 + L + 1), np.uint8)
    rec[:, 0] = ord("@")
    ids = np.arange(first, first + n)
    rec[:, 1:10] = (ids[:, None] // 10 ** np.arange(8, -1, -1)) % 10 + ord("0")
    rec[:, 10] = ord("\n")
    rec[:, head:head + L] = reads
    rec[:, head + L:head + L + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, head + L + 3:-1] = ord("I")
    rec[:, -1] = ord("\n")
    return rec.tobytes()


def n_free_windows(seq: np.ndarray, k: int) -> int:
    """A lower bound of the windows of ``seq`` that no N touches: all
    windows less k for each N."""
    return max(0, len(seq) - k + 1 - k * int((seq == ord("N")).sum()))
