"""``mash paste`` (reference ``CommandPaste.cpp``)."""

from __future__ import annotations

import os
import sys

from mash_tpu_torch.cli.command import Command, Option, split_file
from mash_tpu_torch.core.loader import (
    SUFFIX_SKETCH,
    has_suffix,
    init_from_files,
)
from mash_tpu_torch.core.params import SketchParams
from mash_tpu_torch.io import capnp_msh


class CommandPaste(Command):
    name = "paste"
    summary = "Create a single sketch file from multiple sketch files."
    description = "Create a single sketch file from multiple sketch files."
    argument_string = "<out_prefix> <sketch> [<sketch>] ..."

    def __init__(self):
        super().__init__()
        self.use_option("help")
        self.add_option(
            "list",
            Option(
                Option.BOOLEAN,
                "l",
                "",
                "Input files are lists of file names.",
                "",
            ),
        )

    def run(self) -> int:
        if len(self.arguments) < 2 or self.get_option("help").active:
            self.print_help()
            return 0

        err = sys.stderr
        files = []
        for arg in self.arguments[1:]:
            if self.get_option("list").active:
                files.extend(split_file(arg))
            else:
                files.append(arg)

        for path in files:
            if not has_suffix(path, SUFFIX_SKETCH):
                err.write(
                    'ERROR: The file "%s" does not look like a sketch.\n'
                    % path
                )
                return 1

        params = SketchParams()
        params.parallelism = 1
        sketch_set = init_from_files(files, params)

        out = self.arguments[0]
        if not has_suffix(out, SUFFIX_SKETCH):
            out += SUFFIX_SKETCH
        if os.path.exists(out):
            err.write('ERROR: "%s" exists; remove to write.\n' % out)
            raise SystemExit(1)

        err.write("Writing %s...\n" % out)
        capnp_msh.write_msh(
            out, sketch_set.params, sketch_set.references
        )
        return 0
