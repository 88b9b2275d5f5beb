"""``mash bounds`` (reference ``CommandBounds.cpp``).

Pure host math: inverts the binomial CDF at the (1-p)/2 quantile for both
the Mash-distance and screen/containment Jaccard models.  The reference's
scan over x is evaluated in blocks of one vectorized CDF call each
(:func:`first_above`), which gives the same x.
"""

from __future__ import annotations

import math
import sys

import numpy as np
from scipy.stats import binom

from mash_tpu_torch.cli.command import Command, Option
from mash_tpu_torch.io.formatting import cpp_double


def first_above(q: float, p: float, n: int) -> int:
    """The least x in ``[0, n)`` with ``binomial_cdf(x, p, n) > q``, else
    n: the reference's loop (``CommandBounds.cpp``), one block of x at a
    time, each block twice the last."""
    x0, block = 0, 1024
    while x0 < n:
        xs = np.arange(x0, min(n, x0 + block))
        above = np.flatnonzero(binom.cdf(xs, n, p) > q)
        if above.size:
            return x0 + int(above[0])
        x0 += block
        block *= 2
    return n


class CommandBounds(Command):
    name = "bounds"
    summary = "Print a table of Mash error bounds."
    description = (
        "Print a table of Mash error bounds for various sketch sizes and "
        "Mash distances based on a given k-mer size and desired "
        "confidence. Note that these calculations assume sequences are "
        "much larger than the sketch size, and will overestimate error "
        "bounds if this is not the case."
    )
    argument_string = ""

    def __init__(self):
        super().__init__()
        self.use_option("help")
        self.add_option(
            "kmer",
            Option(Option.INTEGER, "k", "", "k-mer size.", "21", 1, 32),
        )
        self.add_option(
            "prob",
            Option(
                Option.NUMBER,
                "p",
                "",
                "Mash distance estimates will be within the given error "
                "bounds with this probability.",
                "0.99",
                0,
                1,
            ),
        )

    def run(self) -> int:
        if self.get_option("help").active:
            self.print_help()
            return 0

        out = sys.stdout
        sketch_sizes = [100, 500, 1000, 5000, 10000, 50000, 100000, 500000,
                        1000000]
        dists = [0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4]

        k = int(self.get_option("kmer").get_argument_as_number())
        prob = self.get_option("prob").get_argument_as_number()
        q2 = (1.0 - prob) / 2.0

        out.write("\nParameters (run with -h for details):\n")
        out.write("   k:   %d\n" % k)
        out.write("   p:   %s\n\n" % cpp_double(prob))

        for cont in (0, 1):
            out.write(
                "\tScreen distance\n" if cont else "\tMash distance\n"
            )
            out.write("Sketch")
            for d in dists:
                out.write("\t%s" % cpp_double(d))
            out.write("\n")
            for s in sketch_sizes:
                out.write(str(s))
                for d in dists:
                    if cont:
                        m2j = (1.0 - d) ** k
                    else:
                        m2j = 1.0 / (2.0 * math.exp(k * d) - 1.0)
                    je = first_above(q2, m2j, s) / s
                    if cont:
                        j2m = 1.0 - je ** (1.0 / k)
                    else:
                        j2m = (
                            -1.0
                            / k
                            * math.log(2.0 * je / (1.0 + je))
                            if je > 0
                            else float("inf")
                        )
                    out.write("\t%s" % cpp_double(j2m - d))
                out.write("\n")
            out.write("\n")
        return 0
