"""``mash within`` — containment scores (reference ``CommandContain.cpp``,
compile-gated behind ``COMMAND_WITHIN`` there, always available here).

Under a multi-process launch rank 0 alone computes and writes everything.
"""

from __future__ import annotations

import math
import sys

import torch

from mash_tpu_torch.cli.command import Command, Option, split_file
from mash_tpu_torch.cli.setup import sketch_parameter_setup
from mash_tpu_torch.core.loader import (
    SUFFIX_SKETCH,
    has_suffix,
    init_from_files,
)
from mash_tpu_torch.io.formatting import cpp_double
from mash_tpu_torch.ops.distance import (
    _upload,
    pad_sketches,
    pairwise_containment,
)
from mash_tpu_torch.parallel import multihost as mh
from mash_tpu_torch.utils import resolve_device, stage


class CommandContain(Command):
    name = "within"
    summary = "Estimate the containment of query sequences within references."
    description = (
        "Estimate the containment of each query file (or sequence with "
        "-i) in the reference. Both the reference and queries can be "
        "fasta or fastq, gzipped or not, or mash sketch files (.msh) with "
        "matching k-mer sizes. Query files can also be files of file "
        "names (see -l). The score is the number of intersecting "
        "min-hashes divided by the query set size. The output format is "
        "[score, error-bound, reference-ID, query-ID]."
    )
    argument_string = "<reference> <query> [<query>] ..."

    def __init__(self):
        super().__init__()
        self.add_option(
            "list",
            Option(
                Option.BOOLEAN,
                "l",
                "Input",
                "List input. Each query file contains a list of sequence "
                "files, one per line. The reference file is not affected.",
                "",
            ),
        )
        self.add_option(
            "errorThreshold",
            Option(
                Option.NUMBER,
                "e",
                "Output",
                "Error bound threshold for reporting scores values. Error "
                "bounds can generally be increased by increasing the "
                "sketch size of the reference.",
                "0.05",
            ),
        )
        self.use_option("help")
        self.use_sketch_options()

    def run(self) -> int:
        if len(self.arguments) < 2 or self.get_option("help").active:
            self.print_help()
            return 0

        err = sys.stderr
        out = sys.stdout
        # small-output command: rank 0 computes and writes everything
        # (a multi-process launch joins the group for every command;
        # without this gate every process would print the full output)
        if mh.process_index() != 0:
            return 0
        params = sketch_parameter_setup(self)
        if params is None:
            return 1
        params.error = self.get_option(
            "errorThreshold"
        ).get_argument_as_number()

        file_reference = self.arguments[0]
        is_sketch = has_suffix(file_reference, SUFFIX_SKETCH)
        if is_sketch:
            for name in ("kmer", "noncanonical"):
                if self.get_option(name).active:
                    err.write(
                        "ERROR: The option %s cannot be used when a sketch "
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
        if is_sketch:
            params.min_hashes_per_window = (
                sketch_ref.params.min_hashes_per_window
            )
            params.kmer_size = sketch_ref.params.kmer_size
            params.noncanonical = sketch_ref.params.noncanonical
            params.preserve_case = sketch_ref.params.preserve_case
            params.seed = sketch_ref.params.seed
            params.set_alphabet(sketch_ref.params.alphabet_string())
        else:
            err.write("done.\n")

        query_files = []
        for arg in self.arguments[1:]:
            if self.get_option("list").active:
                query_files.extend(split_file(arg))
            else:
                query_files.append(arg)

        sketch_query = init_from_files(
            query_files, params, 0, enforce_parameters=True, contain=True,
            device=device,
        )

        width = max(
            max((len(r.hashes) for r in sketch_ref.references), default=1),
            max(
                (len(r.hashes) for r in sketch_query.references),
                default=1,
            ),
        )
        with stage("within:containment"):
            rh, rn = _upload(*pad_sketches(
                [r.hashes for r in sketch_ref.references], width), device)
            qh, qn = _upload(*pad_sketches(
                [r.hashes for r in sketch_query.references], width), device)
            common, consumed = torch.stack(
                pairwise_containment(rh, rn, qh, qn)).cpu().numpy()

        error_max = params.error
        for i, qry in enumerate(sketch_query.references):
            for j, ref in enumerate(sketch_ref.references):
                c = int(consumed[i, j])
                score = float(common[i, j]) / c if c else float("nan")
                bound = 1.0 / math.sqrt(c) if c else float("inf")
                if bound <= error_max:
                    out.write(
                        "%s\t%s\t%s\t%s\n"
                        % (
                            cpp_double(score),
                            cpp_double(bound),
                            ref.name,
                            qry.name,
                        )
                    )
        return 0
