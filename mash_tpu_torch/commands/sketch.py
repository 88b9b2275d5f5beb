"""``mash sketch`` (reference ``CommandSketch.cpp``).

Genomes, reads mode (``-r``, ``-m``, ``-b``, ``-c``, ``-g``), ``-i``,
``-M`` and windowed sketches (``-W``, written as ``.msw``).  Under a
multi-process launch only rank 0 writes the output.
"""

from __future__ import annotations

import sys

from mash_tpu_torch.cli.command import Command, Option, split_file
from mash_tpu_torch.cli.setup import sketch_parameter_setup, warn_kmer_size
from mash_tpu_torch.core.loader import (
    SUFFIX_SKETCH,
    SUFFIX_SKETCH_WINDOWED,
    has_suffix,
    init_from_files,
    init_from_reads,
)
from mash_tpu_torch.io import capnp_msh
from mash_tpu_torch.parallel.multihost import process_index


class CommandSketch(Command):
    name = "sketch"
    summary = "Create sketches (reduced representations for fast operations)."
    description = (
        "Create a sketch file, which is a reduced representation of a "
        "sequence or set of sequences (based on min-hashes) that can be "
        "used for fast distance estimations. Inputs can be fasta or fastq "
        'files (gzipped or not), and "-" can be given to read from '
        "standard input. Input files can also be files of file names (see "
        "-l). For output, one sketch file will be generated, but it can "
        "have multiple sketches within it, divided by sequences or files "
        "(see -i). By default, the output file name will be the first "
        "input file with a '.msh' extension, or 'stdin.msh' if standard "
        "input is used (see -o)."
    )
    argument_string = "<input> [<input>] ..."

    def __init__(self):
        super().__init__()
        self.use_option("help")
        self.add_option(
            "list",
            Option(
                Option.BOOLEAN,
                "l",
                "Input",
                "List input. Lines in each <input> specify paths to "
                "sequence files, one per line.",
                "",
            ),
        )
        self.add_option(
            "prefix",
            Option(
                Option.FILE,
                "o",
                "Output",
                "Output prefix (first input file used if unspecified). The "
                "suffix '.msh' will be appended.",
                "",
            ),
        )
        self.add_option(
            "id",
            Option(
                Option.FILE,
                "I",
                "Sketch",
                "ID field for sketch of reads (instead of first sequence "
                "ID).",
                "",
            ),
        )
        self.add_option(
            "comment",
            Option(
                Option.FILE,
                "C",
                "Sketch",
                "Comment for a sketch of reads (instead of first sequence "
                "comment).",
                "",
            ),
        )
        self.add_option(
            "counts",
            Option(
                Option.BOOLEAN,
                "M",
                "Sketch",
                "Store multiplicity of each k-mer in each sketch.",
                "",
            ),
        )
        self.use_sketch_options()
        self.use_option("windowed")
        self.use_option("window")

    def run(self) -> int:
        if not self.arguments or self.get_option("help").active:
            self.print_help()
            return 0

        verbosity = 1
        params = sketch_parameter_setup(self)
        if params is None:
            return 1
        params.counts = self.get_option("counts").active

        files = []
        for arg in self.arguments:
            if self.get_option("list").active:
                files.extend(split_file(arg))
            else:
                files.append(arg)

        if (
            self.get_option("id").active
            or self.get_option("comment").active
        ) and len(files) > 1 and not params.reads:
            sys.stderr.write(
                "WARNING: -I and -C will only apply to first sketch\n"
            )

        if params.reads:
            sketch_set = init_from_reads(files, params)
        else:
            sketch_set = init_from_files(files, params, verbosity)

        if self.get_option("id").active:
            sketch_set.references[0].name = self.get_option("id").argument
        if self.get_option("comment").active:
            sketch_set.references[0].comment = self.get_option(
                "comment"
            ).argument

        warning_count = 0
        length_max = 0
        length_max_name = ""
        random_chance = 0.0
        k_min = 0
        # adopted kmer space, as in the reference
        # (CommandSketch.cpp:114: sketch.getKmerSpace())
        threshold = (
            params.warning * sketch_set.params.kmer_space
            / (1.0 - params.warning)
        )
        for i, ref in enumerate(sketch_set.references):
            if ref.length > threshold:
                if warning_count == 0 or ref.length > length_max:
                    length_max = ref.length
                    length_max_name = ref.name
                    random_chance = sketch_set.random_kmer_chance(i)
                    k_min = sketch_set.min_kmer_size(i)
                warning_count += 1

        prefix = self.get_option("prefix").argument
        if not prefix:
            prefix = "stdin" if self.arguments[0] == "-" else self.arguments[0]
        suffix = (
            SUFFIX_SKETCH_WINDOWED if params.windowed else SUFFIX_SKETCH
        )
        if not has_suffix(prefix, suffix):
            prefix += suffix

        if process_index() != 0:
            return 0  # every process holds the merged sketch; rank 0 writes

        sys.stderr.write("Writing to %s...\n" % prefix)
        capnp_msh.write_msh(
            prefix,
            sketch_set.params,
            sketch_set.references,
            sketch_set.position_hashes,
        )

        if warning_count > 0 and not params.reads:
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
