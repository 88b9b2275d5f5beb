"""Text output helpers matching C++ iostream defaults.

The reference prints all floating-point output with ``std::cout`` defaults
(6 significant digits, trailing zeros trimmed, %g-style exponent switch),
which the golden files pin byte-for-byte (``test/ref/genomes.dist``).
Python's ``%.6g`` implements the same rules.
"""

from __future__ import annotations

import math
from typing import List, Optional

from mash_tpu_torch.core.params import SketchParams
from mash_tpu_torch.core.sketch import SketchRef


def cpp_double(x: float) -> str:
    """Format like ``std::cout << (double)x`` (6 significant digits)."""
    if math.isnan(x):
        return "nan"
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    return "%.6g" % x


def json_dump(
    params: SketchParams, references: List[SketchRef]
) -> str:
    """``mash info -d`` JSON dump, byte-identical to the reference.

    Replicates ``CommandInfo::writeJson`` (``src/mash/CommandInfo.cpp:
    222-299``) exactly, including its formatting quirks: a stray space
    before the tab on the ``"sketches"`` line, and — when counts are
    present — no comma between the hashes array and the ``"counts"`` key
    (the reference emits that invalid-JSON shape; goldens are diffed as
    text).
    """
    use64 = params.use64
    out = []
    a = out.append
    a("{\n")
    a('\t"kmer" : %d,\n' % params.kmer_size)
    a('\t"alphabet" : "%s",\n' % params.alphabet_string())
    a('\t"preserveCase" : %s,\n' % ("true" if params.preserve_case else "false"))
    a('\t"canonical" : %s,\n' % ("false" if params.noncanonical else "true"))
    a('\t"sketchSize" : %d,\n' % params.min_hashes_per_window)
    a('\t"hashType" : "%s",\n' % "MurmurHash3_x64_128")
    a('\t"hashBits" : %d,\n' % (64 if use64 else 32))
    a('\t"hashSeed" : %d,\n' % params.seed)
    a(' \t"sketches" :\n')
    a("\t[\n")
    for i, ref in enumerate(references):
        a("\t\t{\n")
        a('\t\t\t"name" : "%s",\n' % ref.name)
        a('\t\t\t"length" : %d,\n' % ref.length)
        a('\t\t\t"comment" : "%s",\n' % ref.comment)
        a('\t\t\t"hashes" :\n')
        a("\t\t\t[\n")
        n = len(ref.hashes)
        for j in range(n):
            h = int(ref.hashes[j])
            if not use64:
                h &= 0xFFFFFFFF
            a("\t\t\t\t%d%s\n" % (h, "," if j < n - 1 else ""))
        a("\t\t\t]\n")
        if ref.counts_sorted and ref.counts is not None:
            a('\t\t\t"counts" :\n')
            a("\t\t\t[\n")
            for j in range(len(ref.counts)):
                # comma keyed to the HASH count, not the counts length —
                # replicating the reference exactly
                # (CommandInfo.cpp:273: j < ref.hashesSorted.size()-1)
                a(
                    "\t\t\t\t%d%s\n"
                    % (int(ref.counts[j]), "," if j < n - 1 else "")
                )
            a("\t\t\t]\n")
        a("\t\t}%s\n" % ("," if i < len(references) - 1 else ""))
    a("\t]\n")
    a("}\n")
    return "".join(out)


def parse_json_dump(text: str):
    """Parse an ``info -d`` JSON dump back into params + references.

    Used to reconstruct sketch files from golden dumps (the reference's
    genome FASTAs are tutorial downloads and not bundled).

    Counts-bearing dumps are not valid JSON — the reference omits the
    comma between the ``hashes`` and ``counts`` arrays and keys the
    counts commas to the HASH count (CommandInfo.cpp:268-276), so the
    text is repaired before parsing (and ``params.counts`` is set so a
    rewrite via ``write_msh`` keeps the counts).
    """
    import json
    import re

    text = text.replace(
        '\t\t\t]\n\t\t\t"counts" :', '\t\t\t],\n\t\t\t"counts" :'
    )
    # a counts array shorter than the hash list leaves a trailing comma
    text = re.sub(r",(\n\t+\])", r"\1", text)
    doc = json.loads(text)
    import numpy as np

    p = SketchParams()
    p.kmer_size = doc["kmer"]
    p.preserve_case = doc["preserveCase"]
    p.noncanonical = not doc["canonical"]
    p.min_hashes_per_window = doc["sketchSize"]
    p.seed = doc["hashSeed"]
    p.set_alphabet(doc["alphabet"])
    refs = []
    for s in doc["sketches"]:
        counts = s.get("counts")
        refs.append(
            SketchRef(
                name=s["name"],
                comment=s["comment"],
                length=s["length"],
                hashes=np.array(s["hashes"], dtype=np.uint64),
                counts=(
                    np.array(counts, dtype=np.uint32)
                    if counts is not None
                    else None
                ),
                counts_sorted=counts is not None,
            )
        )
    p.counts = any(r.counts is not None for r in refs)
    return p, refs
