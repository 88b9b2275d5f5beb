"""``mash dist`` (reference ``CommandDistance.cpp``).

The comparison itself runs as a device kernel over padded sketch matrices
(``mash_tpu_torch.ops.distance``); distance/p-value post-processing and text
output stay on host in float64.  Under a multi-process launch each process
computes and prints only the streamed row stripes it owns (the outputs
concatenate in stripe order), and rank 0 alone the header and the
unstreamed path.
"""

from __future__ import annotations

import sys

import numpy as np

from mash_tpu_torch.cli.command import Command, Option, split_file
from mash_tpu_torch.cli.setup import sketch_parameter_setup, warn_kmer_size
from mash_tpu_torch.core import stats
from mash_tpu_torch.core.loader import (
    has_suffix,
    init_from_files,
    SUFFIX_SKETCH,
)
from mash_tpu_torch.parallel import multihost as mh
from mash_tpu_torch.utils import resolve_device
from mash_tpu_torch.ops.distance import (
    common_denom_tiled,
    pad_sketches,
    stream_pair_stripes,
)

# Above this many pair cells the full [NQ, NR] matrices stream as row
# stripes instead of materializing on host.
STREAM_MIN_CELLS = 1 << 22


class CommandDistance(Command):
    name = "dist"
    summary = "Estimate the distance of query sequences to references."
    description = (
        "Estimate the distance of each query sequence to the reference. "
        "Both the reference and queries can be fasta or fastq, gzipped or "
        "not, or Mash sketch files (.msh) with matching k-mer sizes. Query "
        "files can also be files of file names (see -l). Whole files are "
        "compared by default (see -i). The output fields are "
        "[reference-ID, query-ID, distance, p-value, shared-hashes]."
    )
    argument_string = "<reference> <query> [<query>] ..."

    def __init__(self):
        super().__init__()
        self.use_option("help")
        self.add_option(
            "list",
            Option(
                Option.BOOLEAN,
                "l",
                "Input",
                "List input. Lines in each <query> specify paths to "
                "sequence files, one per line. The reference file is not "
                "affected.",
                "",
            ),
        )
        self.add_option(
            "table",
            Option(
                Option.BOOLEAN,
                "t",
                "Output",
                "Table output (will not report p-values, but fields will "
                "be blank if they do not meet the p-value threshold).",
                "",
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
            "distance",
            Option(
                Option.NUMBER,
                "d",
                "Output",
                "Maximum distance to report.",
                "1.0",
                0.0,
                1.0,
            ),
        )
        self.add_option(
            "comment",
            Option(
                Option.BOOLEAN,
                "C",
                "Output",
                "Show comment fields with reference/query names (denoted "
                "with ':').",
                "",
            ),
        )
        self.use_sketch_options()

    def run(self) -> int:
        if len(self.arguments) < 2 or self.get_option("help").active:
            self.print_help()
            return 0

        err = sys.stderr
        out = sys.stdout
        table = self.get_option("table").active
        comment = self.get_option("comment").active
        pvalue_max = self.get_option("pvalue").get_argument_as_number()
        distance_max = self.get_option("distance").get_argument_as_number()

        params = sketch_parameter_setup(self)
        if params is None:
            return 1

        file_reference = self.arguments[0]
        is_sketch = has_suffix(file_reference, SUFFIX_SKETCH)
        if is_sketch:
            for name in ("kmer", "noncanonical", "protein", "alphabet"):
                if self.get_option(name).active:
                    err.write(
                        "ERROR: The option -%s cannot be used when a sketch "
                        "is provided; it is inherited from the sketch.\n"
                        % self.get_option(name).identifier
                    )
                    return 1
        else:
            err.write(
                "Sketching %s (provide sketch file made with "
                '"mash sketch" to skip)...' % file_reference
            )

        device = resolve_device()
        sketch_ref = init_from_files([file_reference], params, device=device)

        # the reference derives the threshold from the SKETCH's kmer
        # space (adopted from .msh inputs), not the CLI defaults
        # (CommandDistance.cpp:117: sketchRef.getKmerSpace())
        length_threshold = (
            params.warning * sketch_ref.params.kmer_space
            / (1.0 - params.warning)
        )
        warning_count = 0
        length_max = 0
        length_max_name = ""
        random_chance = 0.0
        k_min = 0

        if is_sketch:
            if self.get_option("sketchSize").active:
                if (
                    params.reads
                    and params.min_hashes_per_window
                    != sketch_ref.params.min_hashes_per_window
                ):
                    err.write(
                        "ERROR: The sketch size must match the reference "
                        "when using a bloom filter (leave this option out "
                        "to inherit from the reference sketch).\n"
                    )
                    return 1
            params.min_hashes_per_window = (
                sketch_ref.params.min_hashes_per_window
            )
            params.kmer_size = sketch_ref.params.kmer_size
            params.noncanonical = sketch_ref.params.noncanonical
            params.preserve_case = sketch_ref.params.preserve_case
            params.seed = sketch_ref.params.seed
            params.set_alphabet(sketch_ref.params.alphabet_string())
        else:
            for i, ref in enumerate(sketch_ref.references):
                if ref.length > length_threshold:
                    if warning_count == 0 or ref.length > length_max:
                        length_max = ref.length
                        length_max_name = ref.name
                        random_chance = sketch_ref.random_kmer_chance(i)
                        k_min = sketch_ref.min_kmer_size(i)
                    warning_count += 1
            err.write("done.\n")

        rank0 = mh.process_index() == 0
        if table and rank0:
            # per-process outputs concatenate in stripe order, so the
            # header appears once
            out.write("#query")
            for ref in sketch_ref.references:
                out.write("\t" + ref.name)
            out.write("\n")

        query_files = []
        for arg in self.arguments[1:]:
            if self.get_option("list").active:
                query_files.extend(split_file(arg))
            else:
                query_files.append(arg)

        sketch_query = init_from_files(
            query_files, params, 0, enforce_parameters=True, device=device
        )

        cap = min(
            sketch_query.params.min_hashes_per_window,
            sketch_ref.params.min_hashes_per_window,
        )
        width = max(
            params.min_hashes_per_window,
            max((len(r.hashes) for r in sketch_ref.references), default=1),
            max(
                (len(r.hashes) for r in sketch_query.references), default=1
            ),
        )
        ref_h, ref_n = pad_sketches(
            [r.hashes for r in sketch_ref.references], width
        )
        qry_h, qry_n = pad_sketches(
            [r.hashes for r in sketch_query.references], width
        )
        k = sketch_ref.params.kmer_size
        kmer_space = sketch_ref.params.kmer_space
        refs = sketch_ref.references
        queries = sketch_query.references
        ref_len = np.array([r.length for r in refs], dtype=np.float64)
        qry_len = np.array([r.length for r in queries], dtype=np.float64)

        def emit_block(i0, common, denom):
            """Format query rows [i0, i0+rows) (reference streams in
            input order, ``CommandDistance.cpp:230-236``)."""
            dist = stats.mash_distance_array(common, denom, k)
            pvals = stats.pair_pvalue_array(
                common,
                ref_len[None, :],
                qry_len[i0 : i0 + common.shape[0], None],
                kmer_space,
                denom,
            )
            # Vectorized row formatting (np.char.mod is C printf
            # "%.6g", identical to io.formatting.cpp_double for finite
            # values).
            for r in range(common.shape[0]):
                i = i0 + r
                qry = queries[i]
                drow = dist[r]
                prow = pvals[r]
                passed = np.ones(len(refs), dtype=bool)
                if distance_max >= 0:
                    passed &= drow <= distance_max
                if pvalue_max >= 0:
                    passed &= prow <= pvalue_max
                if table:
                    dstr = np.char.mod("%.6g", drow)
                    cells = np.where(passed, dstr, "")
                    out.write(qry.name)
                    out.write("\t")
                    out.write("\t".join(cells))
                    out.write("\n")
                    continue
                if not passed.any():
                    continue
                idx = np.nonzero(passed)[0]
                dstr = np.char.mod("%.6g", drow[idx])
                pstr = np.char.mod("%.6g", prow[idx])
                qn = qry.name + (":" + qry.comment if comment else "")
                for t, j in enumerate(idx):
                    ref = refs[j]
                    rn = ref.name + (
                        ":" + ref.comment if comment else ""
                    )
                    out.write(
                        "%s\t%s\t%s\t%s\t%d/%d\n"
                        % (
                            rn,
                            qn,
                            dstr[t],
                            pstr[t],
                            int(common[r, j]),
                            int(denom[r, j]),
                        )
                    )

        n_cells = len(queries) * len(refs)
        if n_cells > STREAM_MIN_CELLS and cap < 65536:
            for i0, stripe in stream_pair_stripes(
                qry_h, qry_n, ref_h, ref_n, cap, device,
                stripe_filter=mh.owns_stripe,
            ):
                rows = min(stripe.shape[0], len(queries) - i0)
                if rows <= 0:
                    continue
                emit_block(
                    i0,
                    (stripe[:rows] & np.uint32(0xFFFF)).astype(
                        np.int64
                    ),
                    (stripe[:rows] >> np.uint32(16)).astype(np.int64),
                )
        elif rank0:
            # small outputs: rank 0 computes and writes everything
            if n_cells > STREAM_MIN_CELLS:
                err.write(
                    "WARNING: sketch size %d disables the streamed "
                    "path (needs < 65536); this run holds the full "
                    "%dx%d matrix in memory.\n"
                    % (cap, len(queries), len(refs))
                )
            common, denom = common_denom_tiled(
                qry_h, qry_n, ref_h, ref_n, cap, device,
                use64=sketch_ref.params.use64,
            )
            emit_block(0, common, denom)

        if warning_count > 0 and not params.reads and rank0:
            warn_kmer_size(
                params,
                self,
                length_max,
                length_max_name,
                random_chance,
                k_min,
                warning_count,
            )
        return 0
