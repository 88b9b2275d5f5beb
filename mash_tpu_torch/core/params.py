"""Sketch parameters, mirroring the reference's ``Sketch::Parameters``.

Reference: ``src/mash/Sketch.h:34-106`` (struct fields and defaults) and
``src/mash/Sketch.cpp:1108-1137`` (``setAlphabetFromString`` including the
``use64 = |alphabet|^k > 2^32`` hash-width rule).
"""

from __future__ import annotations

import dataclasses

ALPHABET_NUCLEOTIDE = "ACGT"
ALPHABET_PROTEIN = "ACDEFGHIKLMNPQRSTVWY"

DEFAULT_KMER_SIZE = 21        # reference Command.cpp:168
DEFAULT_SKETCH_SIZE = 1000    # reference Command.cpp:172
DEFAULT_SEED = 42             # reference Command.cpp:178
DEFAULT_WINDOW_SIZE = 10000   # reference Command.cpp:170
DEFAULT_WARNING = 0.01        # reference Command.cpp:176


@dataclasses.dataclass
class SketchParams:
    """All knobs governing sketch construction.

    Field-for-field equivalent of ``Sketch::Parameters``
    (``src/mash/Sketch.h:34-106``); ``alphabet`` is stored as a 256-entry
    boolean membership table exactly like the reference.
    """

    parallelism: int = 1
    kmer_size: int = 0
    alphabet: tuple = dataclasses.field(default_factory=lambda: (False,) * 256)
    alphabet_size: int = 0
    preserve_case: bool = False
    use64: bool = False
    seed: int = 0
    error: float = 0.0
    warning: float = 0.0
    min_hashes_per_window: int = 0   # the sketch size s
    window_size: int = 0
    windowed: bool = False
    concatenated: bool = False
    noncanonical: bool = False
    reads: bool = False
    memory_bound: int = 0            # Bloom filter byte bound (-b)
    min_cov: int = 1                 # -m
    target_cov: float = 0.0          # -c
    genome_size: int = 0             # -g
    counts: bool = False             # store multiplicities (-M)

    # ----- derived helpers -------------------------------------------------

    @property
    def sketch_size(self) -> int:
        return self.min_hashes_per_window

    @property
    def kmer_space(self) -> float:
        """|alphabet| ** k as a float (reference ``Sketch.cpp:509``)."""
        return float(self.alphabet_size) ** self.kmer_size

    def alphabet_string(self) -> str:
        """Ascending-byte alphabet string (``Sketch::getAlphabetAsString``)."""
        return "".join(chr(i) for i in range(256) if self.alphabet[i])

    def set_alphabet(self, characters: str) -> None:
        """Replicates ``setAlphabetFromString`` (``Sketch.cpp:1108-1137``).

        Uppercases each character unless ``preserve_case``; recomputes
        ``alphabet_size`` and the 32/64-bit hash width choice.
        """
        table = [False] * 256
        for ch in characters.encode("latin-1"):
            c = ch
            if not self.preserve_case and 96 < c < 123:
                c -= 32
            table[c] = True
        self.alphabet = tuple(table)
        self.alphabet_size = sum(table)
        self.use64 = float(self.alphabet_size) ** self.kmer_size > 2.0 ** 32

    def copy(self) -> "SketchParams":
        return dataclasses.replace(self)

    def max_hash(self) -> int:
        return (1 << 64) - 1 if self.use64 else (1 << 32) - 1


def default_nucleotide_params(
    kmer_size: int = DEFAULT_KMER_SIZE,
    sketch_size: int = DEFAULT_SKETCH_SIZE,
    seed: int = DEFAULT_SEED,
) -> SketchParams:
    """Convenience constructor with the reference CLI defaults."""
    p = SketchParams(
        kmer_size=kmer_size,
        min_hashes_per_window=sketch_size,
        seed=seed,
        warning=DEFAULT_WARNING,
        window_size=DEFAULT_WINDOW_SIZE,
        concatenated=True,
    )
    p.set_alphabet(ALPHABET_NUCLEOTIDE)
    return p
