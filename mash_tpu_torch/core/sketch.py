"""Sketch containers: the in-memory equivalent of the reference's ``Sketch``.

A :class:`SketchRef` mirrors ``Sketch::Reference`` (``src/mash/Sketch.h:131-139``):
name, comment, sequence length, ascending hash list and optional per-hash
multiplicities.  A :class:`SketchSet` holds many of them plus the parameters
they were built with, and implements the parameter-compatibility /
truncation rules applied when loading ``.msh`` files
(``src/mash/Sketch.cpp:105-253, 907-1067``).
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from mash_tpu_torch.core.params import SketchParams


@dataclass
class SketchRef:
    """One sketch: a named bottom-s set of k-mer hashes."""

    name: str = ""
    comment: str = ""
    length: int = 0
    hashes: np.ndarray = field(
        default_factory=lambda: np.empty(0, dtype=np.uint64)
    )  # ascending
    counts: Optional[np.ndarray] = None  # uint32, aligned with hashes
    counts_sorted: bool = False

    def histogram(self):
        """count -> frequency map (``Sketch::getReferenceHistogram``)."""
        out = {}
        if self.counts is None:
            return out
        for c in self.counts.tolist():
            out[c] = out.get(c, 0) + 1
        return dict(sorted(out.items()))


class SketchSet:
    """A collection of sketches sharing one parameter set."""

    def __init__(self, params: SketchParams):
        self.params = params
        self.references: List[SketchRef] = []
        # windowed mode (.msw): per-reference [n, 2] arrays of
        # (position, hash) minmers, aligned with ``references``
        self.position_hashes: List[np.ndarray] = []

    def __len__(self) -> int:
        return len(self.references)

    def add(self, ref: SketchRef, positions: Optional[np.ndarray] = None) -> None:
        self.references.append(ref)
        self.position_hashes.append(
            positions
            if positions is not None
            else np.empty((0, 2), dtype=np.uint64)
        )

    def loci_by_hash(self):
        """hash -> [(ref_index, position)] index (``Sketch::createIndex``)."""
        out = {}
        for i, arr in enumerate(self.position_hashes):
            for pos, h in np.asarray(arr, dtype=np.uint64).reshape(-1, 2):
                out.setdefault(int(h), []).append((i, int(pos)))
        return out

    @property
    def kmer_space(self) -> float:
        return self.params.kmer_space

    def reference_index(self, name: str) -> int:
        for i, r in enumerate(self.references):
            if r.name == name:
                return i
        return -1

    def random_kmer_chance(self, index: int) -> float:
        """P(random k-mer match) (``Sketch::getRandomKmerChance``)."""
        return 1.0 / (self.kmer_space / self.references[index].length + 1.0)

    def min_kmer_size(self, index: int) -> int:
        """Smallest k meeting the warning threshold (``Sketch.cpp:53-56``)."""
        p = self.params
        return int(
            math.ceil(
                math.log(
                    self.references[index].length * (1 - p.warning) / p.warning
                )
                / math.log(p.alphabet_size)
            )
        )

    def truncate_to_sketch_size(self) -> None:
        """Cut every reference to the current sketch size.

        Mirrors the load-time reduction applied when a ``.msh`` carries more
        hashes than the target size (``src/mash/Sketch.cpp:963-986``).
        """
        s = self.params.sketch_size
        for r in self.references:
            if len(r.hashes) > s:
                r.hashes = r.hashes[:s]
                if r.counts is not None:
                    r.counts = r.counts[:s]


def check_compatibility(
    params: SketchParams,
    other: SketchParams,
    path: str,
    enforce_size: bool = True,
) -> bool:
    """Compatibility gate when mixing sketch files.

    Replicates the skip-with-warning checks of ``Sketch::initFromFiles``
    (``src/mash/Sketch.cpp:119-165``).  Returns True if the file is usable.
    """
    err = sys.stderr
    if other.alphabet_string() != params.alphabet_string():
        err.write(
            "\nWARNING: The sketch file %s has different alphabet (%s) than "
            "the current alphabet (%s). This file will be skipped.\n\n"
            % (path, other.alphabet_string(), params.alphabet_string())
        )
        return False
    if other.seed != params.seed:
        err.write(
            "\nWARNING: The sketch %s has a seed size (%d) that does not "
            "match the current seed (%d). This file will be skipped.\n\n"
            % (path, other.seed, params.seed)
        )
        return False
    if other.kmer_size != params.kmer_size:
        err.write(
            "\nWARNING: The sketch %s has a kmer size (%d) that does not "
            "match the current kmer size (%d). This file will be skipped.\n\n"
            % (path, other.kmer_size, params.kmer_size)
        )
        return False
    if enforce_size and (
        other.min_hashes_per_window < params.min_hashes_per_window
    ):
        err.write(
            "\nWARNING: The sketch file %s has a target sketch size (%d) "
            "that is smaller than the current sketch size (%d). This file "
            "will be skipped.\n\n"
            % (
                path,
                other.min_hashes_per_window,
                params.min_hashes_per_window,
            )
        )
        return False
    if other.noncanonical != params.noncanonical:
        err.write(
            "\nWARNING: The sketch file %s is %s, which is incompatible with "
            "the current setting. This file will be skipped.\n\n"
            % (path, "noncanonical" if other.noncanonical else "canonical")
        )
        return False
    if other.min_hashes_per_window > params.min_hashes_per_window:
        err.write(
            "\nWARNING: The sketch file %s has a target sketch size (%d) "
            "that is larger than the current sketch size (%d). Its sketches "
            "will be reduced.\n\n"
            % (
                path,
                other.min_hashes_per_window,
                params.min_hashes_per_window,
            )
        )
    return True
