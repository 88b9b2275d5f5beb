"""Distance/identity formulas and binomial-tail p-values.

Mirrors the reference math exactly:
- Mash distance ``-ln(2j/(1+j))/k`` with 0/1 special cases and clamping
  (``src/mash/CommandDistance.cpp:387-407``);
- pair p-value with ``r = pX*pY/(pX+pY-pX*pY)`` and a binomial survival
  function over the union size (``CommandDistance.cpp:427-448``);
- screen identity ``j^(1/k)`` (``CommandScreen.cpp:463-482``) and
  ``pValueWithin`` with ``r = setSize/kmerSpace``
  (``CommandScreen.cpp:601-615``).

The reference computes tails with GSL's ``gsl_cdf_binomial_Q(x-1, r, n)``;
scipy's ``binom.sf(x-1, n, r)`` evaluates the same regularized incomplete
beta and matches to well past the 6 printed significant digits (verified
against the golden files down to 1e-229).
"""

from __future__ import annotations

import math

import numpy as np
from scipy.stats import binom


def mash_distance(common: int, denom: int, kmer_size: int) -> float:
    """Distance for one pair (``CommandDistance.cpp:387-407``).

    Check order matches the reference: ``common == denom`` first, so a
    0/0 pair (two empty sketches) is distance 0, not 1.
    """
    if common == denom:  # avoid -0
        return 0.0
    if common == 0:  # avoid inf
        return 1.0
    jac = common / denom
    d = -math.log(2.0 * jac / (1.0 + jac)) / kmer_size
    return min(d, 1.0)


def mash_distance_array(common, denom, kmer_size: int):
    """Vectorized :func:`mash_distance`."""
    common = np.asarray(common, dtype=np.float64)
    denom = np.asarray(denom, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        jac = common / denom
        d = -np.log(2.0 * jac / (1.0 + jac)) / kmer_size
    d = np.minimum(d, 1.0)
    # reference check order: common == denom wins, so 0/0 -> 0
    d = np.where(common == 0, 1.0, d)
    d = np.where(common == denom, 0.0, d)
    return d


def pair_pvalue(
    common: int,
    length_ref: int,
    length_query: int,
    kmer_space: float,
    denom: int,
) -> float:
    """P-value of observing >= common shared hashes by chance."""
    if common == 0:
        return 1.0
    px = 1.0 / (1.0 + kmer_space / length_ref)
    py = 1.0 / (1.0 + kmer_space / length_query)
    r = px * py / (px + py - px * py)
    return float(binom.sf(common - 1, denom, r))


def pair_pvalue_array(common, length_ref, length_query, kmer_space, denom):
    """Vectorized :func:`pair_pvalue` (broadcasting inputs)."""
    common = np.asarray(common)
    length_ref = np.asarray(length_ref, dtype=np.float64)
    length_query = np.asarray(length_query, dtype=np.float64)
    denom = np.asarray(denom)
    px = 1.0 / (1.0 + kmer_space / length_ref)
    py = 1.0 / (1.0 + kmer_space / length_query)
    r = px * py / (px + py - px * py)
    with np.errstate(invalid="ignore"):
        p = binom.sf(common - 1, denom, r)
    return np.where(common == 0, 1.0, p)


def screen_identity(common: int, denom: int, kmer_size: int) -> float:
    """Containment identity estimate (``estimateIdentity``)."""
    if denom == 0:
        return 0.0
    if common == denom:
        return 1.0
    if common == 0:
        return 0.0
    return (common / denom) ** (1.0 / kmer_size)


def pvalue_within(
    common: int, set_size: float, kmer_space: float, sketch_size: int
) -> float:
    """Screen/containment p-value (``pValueWithin``)."""
    if common == 0:
        return 1.0
    r = float(set_size) / kmer_space
    return float(binom.sf(common - 1, sketch_size, r))


def binomial_cdf(x: int, p: float, n: int) -> float:
    """``gsl_cdf_binomial_P(x, p, n)`` equivalent (for ``bounds``)."""
    return float(binom.cdf(x, n, p))
