"""``mash info`` (reference ``CommandInfo.cpp``)."""

from __future__ import annotations

import sys

from mash_tpu_torch.cli.command import Command, Option
from mash_tpu_torch.core.loader import (
    has_suffix,
    SUFFIX_SKETCH,
    SUFFIX_SKETCH_WINDOWED,
)
from mash_tpu_torch.core.params import SketchParams
from mash_tpu_torch.io import capnp_msh
from mash_tpu_torch.io.formatting import json_dump

HASH_NAME = "MurmurHash3_x64_128"


class CommandInfo(Command):
    name = "info"
    summary = "Display information about sketch files."
    description = "Display information about sketch files."
    argument_string = "<sketch>"

    def __init__(self):
        super().__init__()
        self.use_option("help")
        self.add_option(
            "header",
            Option(
                Option.BOOLEAN,
                "H",
                "",
                "Only show header info. Do not list each sketch. "
                "Incompatible with -d, -t and -c.",
                "",
            ),
        )
        self.add_option(
            "tabular",
            Option(
                Option.BOOLEAN,
                "t",
                "",
                "Tabular output (rather than padded), with no header. "
                "Incompatible with -d, -H and -c.",
                "",
            ),
        )
        self.add_option(
            "counts",
            Option(
                Option.BOOLEAN,
                "c",
                "",
                "Show hash count histograms for each sketch. Incompatible "
                "with -d, -H and -t.",
                "",
            ),
        )
        self.add_option(
            "dump",
            Option(
                Option.BOOLEAN,
                "d",
                "",
                "Dump sketches in JSON format. Incompatible with -H, -t, "
                "and -c.",
                "",
            ),
        )

    def run(self) -> int:
        if len(self.arguments) != 1 or self.get_option("help").active:
            self.print_help()
            return 0

        err = sys.stderr
        out = sys.stdout
        header = self.get_option("header").active
        tabular = self.get_option("tabular").active
        counts = self.get_option("counts").active
        dump = self.get_option("dump").active

        for a, b in (
            ("header", "tabular"),
            ("header", "counts"),
            ("tabular", "counts"),
        ):
            if self.get_option(a).active and self.get_option(b).active:
                err.write(
                    "ERROR: The options -%s and -%s are incompatible.\n"
                    % (
                        self.get_option(a).identifier,
                        self.get_option(b).identifier,
                    )
                )
                return 1
        if dump:
            for o in ("tabular", "header", "counts"):
                if self.get_option(o).active:
                    err.write(
                        "ERROR: The options -d and -%s are incompatible.\n"
                        % self.get_option(o).identifier
                    )
                    return 1

        path = self.arguments[0]
        # also accept windowed sketches (.msw) — the reference's info
        # rejects them (CommandInfo.cpp:94), but they are first-class
        # outputs of `sketch -W` here and decode with the same reader
        if not (
            has_suffix(path, SUFFIX_SKETCH)
            or has_suffix(path, SUFFIX_SKETCH_WINDOWED)
        ):
            err.write(
                'ERROR: The file "%s" does not look like a sketch.\n' % path
            )
            return 1

        if header:
            params, reference_count = capnp_msh.read_msh_header(path)
            references = []
        else:
            params = SketchParams()
            from mash_tpu_torch.core.loader import adopt_params_from_msh

            # one read serves adoption + the full decode (multi-GB DB
            # sketches must not be slurped twice; cf. loader)
            with open(path, "rb") as f:
                data = f.read()
            adopt_params_from_msh(params, path, data=data)
            msh = capnp_msh.read_msh(
                path, max_hashes=params.min_hashes_per_window,
                data=data,
            )
            del data
            references = msh.references
            reference_count = len(references)

        if counts:
            return self._print_counts(params, references)
        if dump:
            out.write(json_dump(params, references))
            return 0

        if tabular:
            out.write("#Hashes\tLength\tID\tComment\n")
        else:
            alphabet = params.alphabet_string()
            out.write("Header:\n")
            out.write(
                "  Hash function (seed):          %s (%d)\n"
                % (HASH_NAME, params.seed)
            )
            out.write(
                "  K-mer size:                    %d (%s-bit hashes)\n"
                % (params.kmer_size, "64" if params.use64 else "32")
            )
            out.write(
                "  Alphabet:                      %s%s%s\n"
                % (
                    alphabet,
                    "" if params.noncanonical else " (canonical)",
                    " (case-sensitive)" if params.preserve_case else "",
                )
            )
            out.write(
                "  Target min-hashes per sketch:  %d\n"
                % params.min_hashes_per_window
            )
            out.write("  Sketches:                      %d\n" % reference_count)

        if not header:
            if tabular:
                for ref in references:
                    out.write(
                        "%d\t%d\t%s\t%s\n"
                        % (len(ref.hashes), ref.length, ref.name, ref.comment)
                    )
            else:
                out.write("\nSketches:\n")
                # the reference renders this with its terminal column
                # renderer (CommandInfo.cpp:180: printColumns(columns,
                # 2, 2, "-", 0) — indent 2, spacing 2); the shared
                # renderer's off-tty width cap applies as everywhere
                from mash_tpu_torch.cli.command import print_columns

                cols = [
                    ["[Hashes]"],
                    ["[Length]"],
                    ["[ID]"],
                    ["[Comment]"],
                ]
                for r in references:
                    cols[0].append(str(len(r.hashes)))
                    cols[1].append(str(r.length))
                    cols[2].append(r.name)
                    cols[3].append(r.comment)
                print_columns(out, cols)
        return 0

    def _print_counts(self, params, references) -> int:
        err = sys.stderr
        out = sys.stdout
        if not references:
            err.write("ERROR: Sketch file contains no sketches\n")
            return 1
        if references[0].counts is None or len(references[0].counts) == 0:
            err.write(
                "ERROR: Sketch file does not have hash counts. Re-sketch "
                "with -M to use this feature.\n"
            )
            return 1
        out.write("#Sketch\tBin\tFrequency\n")
        for ref in references:
            for count, freq in ref.histogram().items():
                out.write("%s\t%d\t%d\n" % (ref.name, count, freq))
        return 0
