"""``mash taxscreen`` (reference ``CommandTaxScreen.cpp``).

Same streaming containment pipeline as ``screen`` (shared device
kernels, and the same multi-process sharding of the pool), followed by
per-hash LCA assignment and a Kraken-style clade report, written by rank 0.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from mash_tpu_torch.cli.command import Command, Option
from mash_tpu_torch.commands.screen import load_screen_db, stream_mixture
from mash_tpu_torch.ops import screen_ops, sketch_ops
from mash_tpu_torch.parallel import multihost as mh
from mash_tpu_torch.taxonomy import TaxCounts, TaxDB, rollup_counts
from mash_tpu_torch.utils import resolve_device, stage


class CommandTaxScreen(Command):
    name = "taxscreen"
    summary = "Create Kraken-style taxonomic report based on mash screen."
    description = (
        "Create Kraken-style taxonomic report based on how well query "
        "sequences are contained within a pool of sequences. The queries "
        "must be formatted as a single Mash sketch file (.msh), created "
        "with the `mash sketch` command. The <pool> files can be contigs "
        "or reads, in fasta or fastq, gzipped or not, and \"-\" can be "
        "given for <pool> to read from standard input. The <pool> "
        "sequences are assumed to be nucleotides, and will be 6-frame "
        "translated if the <queries> are amino acids. The output fields "
        "are [total percent of hashes, number of contained hashes in the "
        "clade, number of contained hashes in the taxon, total number of "
        "hashes in the clade, total number of hashes in the taxon, rank, "
        "taxonomy ID, padded name]."
    )
    argument_string = "<queries>.msh <pool> [<pool>] ..."

    def __init__(self):
        super().__init__()
        self.use_option("help")
        self.use_option("threads")
        # NB: the reference declares -i/-v but never applies them in
        # taxscreen (CommandTaxScreen.cpp:73-74 reads the values and no
        # code uses them); they are accepted-but-inert here for parity.
        self.add_option(
            "identity",
            Option(
                Option.NUMBER,
                "i",
                "Output",
                "Minimum identity to report. Inclusive unless set to zero, "
                "in which case only identities greater than zero (i.e. "
                "with at least one shared hash) will be reported. Set to "
                "-1 to output everything.",
                "0",
                -1.0,
                1.0,
            ),
        )
        self.add_option(
            "pvalue",
            Option(
                Option.NUMBER,
                "v",
                "Output",
                "Maximum p-value to report.",
                "1.0",
                0.0,
                1.0,
            ),
        )
        self.add_option(
            "mapping-file",
            Option(
                Option.STRING,
                "m",
                "",
                "Mapping file from reference name to taxonomy ID",
                "",
            ),
        )
        self.add_option(
            "taxonomy-dir",
            Option(
                Option.STRING,
                "t",
                "",
                "Directory containing NCBI taxonomy dump",
                ".",
            ),
        )

    def run(self) -> int:
        if len(self.arguments) < 2 or self.get_option("help").active:
            self.print_help()
            return 0

        err = sys.stderr
        out = sys.stdout
        taxonomy_dir = self.get_option("taxonomy-dir").argument
        mapping_file = self.get_option("mapping-file").argument
        with stage("screen:load_msh"):
            sketch, params, trans = load_screen_db(self, err)
        device = resolve_device()

        names_dump = os.path.join(taxonomy_dir, "names.dmp")
        nodes_dump = os.path.join(taxonomy_dir, "nodes.dmp")
        if not os.path.exists(names_dump) or not os.path.exists(nodes_dump):
            err.write(
                "Could not find a file names.dmp or nodes.dmp in directory "
                "%s\n To download the required taxonomy files into the "
                "current directory, use the following commands:\n"
                "   wget ftp://ftp.ncbi.nih.gov/pub/taxonomy/"
                "taxdump.tar.gz\n   tar xvvf taxdump.tar.gz\n\n"
                % taxonomy_dir
            )
            raise SystemExit(1)
        err.write("Loading taxonomy files ...\n")
        taxdb = TaxDB(names_dump, nodes_dump)

        err.write("Reading mapping file ...\n")
        refs = sketch.references
        reference_tax_ids = [0] * len(refs)
        if mapping_file:
            ref_tax_map = {}
            with open(mapping_file) as f:
                for line in f:
                    parts = line.rstrip("\n").split(None, 1)
                    if len(parts) != 2:
                        continue
                    try:
                        tax_id = int(parts[0])
                    except ValueError:
                        # the reference's `mappingFile >> taxID` stream
                        # extraction fails and stops reading here
                        # (CommandTaxScreen.cpp:128); match that rather
                        # than crashing
                        break
                    # emplace keeps the FIRST occurrence of a name
                    # (CommandTaxScreen.cpp:132)
                    ref_tax_map.setdefault(parts[1], tax_id)
            for i, ref in enumerate(refs):
                reference_tax_ids[i] = ref_tax_map.get(ref.name, 0)
        for i, ref in enumerate(refs):
            if reference_tax_ids[i] == 0:
                # stream-extraction semantics: each "taxid" token reads
                # the next word as an int; a FAILED extraction zeroes
                # the value and ends the scan (C++11 operator>>,
                # CommandTaxScreen.cpp:152-156)
                words = ref.comment.split()
                j = 0
                while j < len(words):
                    if words[j] == "taxid":
                        try:
                            reference_tax_ids[i] = int(words[j + 1])
                        except (ValueError, IndexError):
                            reference_tax_ids[i] = 0
                            break
                        j += 2
                    else:
                        j += 1
            if reference_tax_ids[i] == 0:
                err.write(
                    "Could not find taxID for reference %s in comment "
                    "field or mapping file!\n" % ref.name
                )

        err.write("Loading %s...\n" % self.arguments[0])
        with stage("screen:db_table"):
            db_hashes, seg_starts, ref_ids = screen_ops.build_db_table(
                [r.hashes for r in refs]
            )
        err.write("   %d distinct hashes.\n" % len(db_hashes))

        with stage("screen:stream"):
            finalize, counts_dev, state, saw_any = stream_mixture(
                params, db_hashes, self.arguments[1:], trans, err, device
            )
        if not saw_any:
            err.write("\nERROR: Did not find sequence records in inputs\n")
            raise SystemExit(1)

        set_size = int(
            sketch_ops.estimate_set_size(state, params.use64)
        )
        err.write(
            "   Estimated distinct%s k-mers in pool: %d\n"
            % (" (translated)" if trans else "", set_size)
        )
        if set_size == 0:
            err.write("WARNING: no valid k-mers in input.\n")

        err.write("Assigning LCA taxIDs to hashes ...\n")
        with stage("screen:counts"):
            counts_host = mh.sum_counts_across_hosts(finalize(counts_dev))
        if mh.process_index() != 0:
            return 0  # rank 0 writes the report
        min_cov = 1
        tax_ids_arr = np.array(reference_tax_ids, dtype=np.int64)

        counts: dict = {}
        with stage("taxscreen:lca"):
            for h_idx in range(len(db_hashes)):
                lca = 0
                for e in range(seg_starts[h_idx], seg_starts[h_idx + 1]):
                    lca = taxdb.lca(int(tax_ids_arr[ref_ids[e]]), lca)
                tc = counts.setdefault(lca, TaxCounts())
                tc.tax_hash_count += 1
                if counts_host[h_idx] >= min_cov:
                    tc.tax_count += 1

        total_count, total_hash_count = rollup_counts(taxdb, counts)

        err.write("Writing output...\n")
        taxdb.write_report(out, counts, total_count, total_hash_count)
        return 0
