"""NCBI taxonomy database: parsing, LCA, Kraken-style report.

Reimplements ``src/mash/taxdb.hpp`` (names.dmp/nodes.dmp parsing, the
path-marking lowest-common-ancestor walk, and the recursive clade-count
report used by ``mash taxscreen``), matching its output format and edge
cases (unknown taxIDs fall back to 1; the root, taxID 1, is never part of
the marked path).  A host-only copy of ``mash_tpu.taxonomy``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class TaxEntry:
    tax_id: int
    rank: str
    name: str = ""
    parent: Optional["TaxEntry"] = None


@dataclass
class TaxCounts:
    clade_count: int = 0
    tax_count: int = 0
    tax_hash_count: int = 0
    clade_hash_count: int = 0
    children: List[int] = field(default_factory=list)


class TaxDB:
    """Parsed NCBI taxonomy (``TaxDB`` in ``taxdb.hpp:48-156``)."""

    def __init__(self, names_dump: str, nodes_dump: str):
        self.entries: Dict[int, TaxEntry] = {}
        self._lca_cache: Dict[tuple, int] = {}
        parent_ids: Dict[int, int] = {}
        with open(nodes_dump) as f:
            for line in f:
                parts = [p.strip() for p in line.split("|")]
                if len(parts) < 3:
                    continue
                try:
                    tax_id = int(parts[0])
                    parent_id = int(parts[1])
                except ValueError:
                    # the reference's stream extraction fails on a
                    # malformed record and stops parsing, proceeding
                    # with the partial taxonomy (taxdb.hpp:117)
                    break
                rank = parts[2]
                self.entries[tax_id] = TaxEntry(tax_id, rank)
                parent_ids[tax_id] = parent_id
        for tax_id, parent_id in parent_ids.items():
            e = self.entries[tax_id]
            if tax_id != parent_id:
                p = self.entries.get(parent_id)
                if p is None:
                    sys.stderr.write(
                        "Could not find parent with tax ID %d for tax ID "
                        "%d\n" % (parent_id, tax_id)
                    )
                else:
                    e.parent = p
        with open(names_dump) as f:
            for line in f:
                parts = [p.strip() for p in line.split("|")]
                if len(parts) < 4:
                    continue
                if parts[3] == "scientific name":
                    e = self.entries.get(int(parts[0]))
                    if e is not None:
                        e.name = parts[1]
        sys.stderr.write("   %d distinct taxa\n" % len(self.entries))

    def get_entry(self, tax_id: int) -> Optional[TaxEntry]:
        e = self.entries.get(tax_id)
        if e is None:
            sys.stderr.write(
                "Couldn't find tax entry with taxID %d\n" % tax_id
            )
        return e

    def lca(self, a: int, b: int) -> int:
        """Lowest common ancestor (``taxdb.hpp:158-190``).

        Resolved pairs are memoized: the per-hash LCA loop asks the
        same handful of (a, b) taxid pairs hundreds of thousands of
        times on large DBs.  Missing-ID results are NOT cached so their
        per-call warnings keep the reference's behavior.
        """
        if b == 0:
            return a
        if a == 0:
            return b
        key = (a, b)
        hit = self._lca_cache.get(key)
        if hit is not None:
            return hit
        r = self._lca_walk(a, b)
        if r is not None:
            self._lca_cache[key] = r
            return r
        return 1

    def _lca_walk(self, a: int, b: int):
        """The parent-chain walk; None when an ID is missing."""
        ta = self.entries.get(a)
        if ta is None:
            sys.stderr.write(
                "TaxID %d not in database - ignoring it.\n" % a
            )
            return None
        tb = self.entries.get(b)
        if tb is None:
            sys.stderr.write(
                "TaxID %d not in database - ignoring it.\n" % b
            )
            return None
        a_path = set()
        p = ta
        while p is not None and p.tax_id > 1 and p.parent is not None:
            if p.tax_id == b:
                return b
            a_path.add(id(p))
            p = p.parent
        q = tb
        while q.tax_id > 0 and q.parent is not None:
            if id(q) in a_path:
                return q.tax_id
            q = q.parent
        return 1

    # -- report ---------------------------------------------------------------

    def write_report(
        self,
        out,
        counts: Dict[int, TaxCounts],
        total_counts: int,
        total_hash_counts: int,
        tax_id: int = 0,
        depth: int = 0,
    ) -> None:
        """Kraken-style indented clade report (``taxdb.hpp:192-236``)."""
        tc = counts.get(tax_id, TaxCounts())
        if tax_id == 0:
            out.write(
                "%\thashes\ttaxHashes\thashesDB\ttaxHashesDB\ttaxID\trank"
                "\tname\n"
            )
            if tc.clade_count > 0:  # should not happen (see reference)
                out.write(
                    "%.4f\t%d\t%d\tno rank\t0\tunclassified\n"
                    % (
                        100.0 * tc.clade_count / float(total_counts),
                        tc.clade_count,
                        tc.tax_count,
                    )
                )
            self.write_report(
                out, counts, total_counts, total_hash_counts, 1, 0
            )
        else:
            if tc.clade_count == 0:
                return
            taxon = self.get_entry(tax_id)
            out.write(
                "%.4f\t%d\t%d\t%d\t%d\t%s\t%d\t%s%s\n"
                % (
                    100.0 * tc.clade_count / float(total_counts),
                    tc.clade_count,
                    tc.tax_count,
                    tc.clade_hash_count,
                    tc.tax_hash_count,
                    taxon.rank if taxon else "",
                    tax_id,
                    " " * (2 * depth),
                    taxon.name if taxon else "",
                )
            )
            children = sorted(
                tc.children,
                key=lambda c: -counts[c].clade_count
                if c in counts
                else 0,
            )
            for child in children:
                if child in counts:
                    self.write_report(
                        out,
                        counts,
                        total_counts,
                        total_hash_counts,
                        child,
                        depth + 1,
                    )
                else:
                    break


def rollup_counts(
    taxdb: TaxDB, counts: Dict[int, TaxCounts]
) -> tuple:
    """Clade-count accumulation (``CommandTaxScreen.cpp:442-471``).

    Adds each taxon's counts to itself and every ancestor, and maintains
    ascending children lists on the way up.  Returns
    (total_count, total_hash_count).
    """
    total_count = 0
    total_hash_count = 0
    import bisect

    for tax_id in list(counts.keys()):
        tc = counts[tax_id]
        hash_count = tc.tax_hash_count
        total_hash_count += hash_count
        count = tc.tax_count
        total_count += count
        taxon = taxdb.get_entry(tax_id)
        while taxon is not None:
            node = counts.setdefault(taxon.tax_id, TaxCounts())
            node.clade_count += count
            node.clade_hash_count += hash_count
            if taxon.parent is not None:
                pc = counts.setdefault(
                    taxon.parent.tax_id, TaxCounts()
                ).children
                i = bisect.bisect_left(pc, taxon.tax_id)
                if i == len(pc) or pc[i] != taxon.tax_id:
                    pc.insert(i, taxon.tax_id)
                taxon = taxon.parent
            else:
                break
    return total_count, total_hash_count
