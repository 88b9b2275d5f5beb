"""What one measured window produced: the work it finished and the
answers the program gave, for the metrics and for the comparison."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Outcome:
    """``units``: genomes sketched or mixture parts streamed in the
    window; ``bases``: their bases; ``windows``: the k-mer windows they
    hold that no N touches; ``out_bytes``: the least bytes the path's
    answers write (the work :mod:`h100_bench.roofline` counts).
    ``answers``: the program's outputs, as the path's reference reads
    them."""

    units: int
    bases: int
    windows: int
    out_bytes: int = 0
    answers: dict = field(default_factory=dict)
