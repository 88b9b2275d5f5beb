"""Typed option registry + argv parser (reference ``Command.{h,cpp}``).

The reference uses single-dash identifiers of any length (``-k``, ``-s``,
``-pacbio``), a shared catalog of sketch options with global defaults, and
per-command option sets — argparse can't express that, so the small parser
is reimplemented here (``src/mash/Command.cpp:311-347``), including Size
suffix handling (``Command.cpp:93-155``) and range validation.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional

from mash_tpu_torch._version import COMPAT_VERSION


class OptionError(SystemExit):
    pass


class Option:
    BOOLEAN = "Boolean"
    NUMBER = "Number"
    INTEGER = "Integer"
    SIZE = "Size"
    FILE = "File"
    STRING = "String"

    def __init__(
        self,
        type_: str,
        identifier: str,
        category: str,
        description: str,
        argument_default: str = "",
        argument_min: float = 0.0,
        argument_max: float = 0.0,
    ):
        self.type = type_
        self.identifier = identifier
        self.category = category
        self.description = description
        self.argument_default = argument_default
        self.argument_min = argument_min
        self.argument_max = argument_max
        self.active = False
        self.argument = ""
        self.argument_as_number = 0.0
        self.set_argument(argument_default)

    def copy(self) -> "Option":
        o = Option(
            self.type,
            self.identifier,
            self.category,
            self.description,
            self.argument_default,
            self.argument_min,
            self.argument_max,
        )
        return o

    def set_argument(self, argument: str) -> None:
        """Validate + convert, replicating ``Option::setArgument``."""
        self.argument = argument
        if self.type in (Option.NUMBER, Option.INTEGER):
            if argument == "":
                self.argument_as_number = 0.0
                return
            failed = False
            try:
                value = float(argument)
                if self.argument_min != self.argument_max and (
                    value < self.argument_min or value > self.argument_max
                ):
                    failed = True
                elif self.type == Option.INTEGER and int(value) != value:
                    failed = True
            except ValueError:
                failed = True
                value = 0.0
            if failed:
                msg = "ERROR: Argument to -%s must be a%s" % (
                    self.identifier,
                    "n integer" if self.type == Option.INTEGER else " number",
                )
                if self.argument_min != self.argument_max:
                    msg += " between %g and %g" % (
                        self.argument_min,
                        self.argument_max,
                    )
                sys.stderr.write(msg + " (%s given)\n" % argument)
                raise OptionError(1)
            self.argument_as_number = value
        elif self.type == Option.SIZE:
            if argument == "":
                self.argument_as_number = 0.0
                return
            factor = 1
            arg = argument
            suffix = arg[-1]
            if not suffix.isdigit():
                factors = {
                    "k": 1000,
                    "K": 1000,
                    "m": 10**6,
                    "M": 10**6,
                    "g": 10**9,
                    "G": 10**9,
                    "t": 10**12,
                    "T": 10**12,
                }
                if suffix not in factors:
                    sys.stderr.write(
                        'ERROR: Unrecognized unit ("%s") in argument to -%s.'
                        " If specified, unit must be one of [kKmMgGtT].\n"
                        % (suffix, self.identifier)
                    )
                    raise OptionError(1)
                factor = factors[suffix]
                arg = arg[:-1]
            fail = False
            try:
                value = float(arg)
            except ValueError:
                fail = True
                value = 0.0
            if value <= 0 or int(value) != value:
                fail = True
            if fail:
                sys.stderr.write(
                    "ERROR: Argument to -%s must be a whole number, "
                    "optionally followed by one of [kKmMgGtT].\n"
                    % self.identifier
                )
                raise OptionError(1)
            self.argument_as_number = value * factor

    def get_argument_as_number(self) -> float:
        return self.argument_as_number


def _available_options() -> Dict[str, Option]:
    """The shared option catalog (``Command.cpp:167-191``)."""
    O = Option
    return {
        "help": O(O.BOOLEAN, "h", "", "Help", ""),
        "kmer": O(
            O.INTEGER,
            "k",
            "Sketch",
            "K-mer size. Hashes will be based on strings of this many "
            "nucleotides. Canonical nucleotides are used by default (see "
            "Alphabet options below).",
            "21",
            1,
            32,
        ),
        "windowed": O(O.BOOLEAN, "W", "Sketch", "Windowed", ""),
        "window": O(
            O.INTEGER,
            "L",
            "Window",
            "Window length. Hashes that are minima in any window of this "
            "size will be stored.",
            "10000",
        ),
        "sketchSize": O(
            O.INTEGER,
            "s",
            "Sketch",
            "Sketch size. Each sketch will have at most this many "
            "non-redundant min-hashes.",
            "1000",
        ),
        "verbose": O(O.BOOLEAN, "v", "Output", "Verbose", ""),
        "silent": O(O.BOOLEAN, "s", "Output", "Silent", ""),
        "individual": O(
            O.BOOLEAN,
            "i",
            "Sketch",
            "Sketch individual sequences, rather than whole files, e.g. for "
            "multi-fastas of single-chromosome genomes or pair-wise gene "
            "comparisons.",
            "",
        ),
        "warning": O(
            O.NUMBER,
            "w",
            "Sketch",
            "Probability threshold for warning about low k-mer size.",
            "0.01",
            0,
            1,
        ),
        "reads": O(
            O.BOOLEAN,
            "r",
            "Sketch",
            "Input is a read set. See Reads options below. Incompatible "
            "with -i.",
            "",
        ),
        "seed": O(
            O.INTEGER,
            "S",
            "Sketch",
            "Seed to provide to the hash function.",
            "42",
            0,
            0xFFFFFFFF,
        ),
        "memory": O(
            O.SIZE,
            "b",
            "Reads",
            "Use a Bloom filter of this size (raw bytes or with K/M/G/T) to "
            "filter out unique k-mers. This is useful if exact filtering "
            "with -m uses too much memory. However, some unique k-mers may "
            "pass erroneously, and copies cannot be counted beyond 2. "
            "Implies -r.",
        ),
        "minCov": O(
            O.INTEGER,
            "m",
            "Reads",
            "Minimum copies of each k-mer required to pass noise filter for "
            "reads. Implies -r.",
            "1",
        ),
        "targetCov": O(
            O.NUMBER,
            "c",
            "Reads",
            "Target coverage. Sketching will conclude if this coverage is "
            "reached before the end of the input file (estimated by average "
            "k-mer multiplicity). Implies -r.",
        ),
        "genome": O(
            O.SIZE,
            "g",
            "Reads",
            "Genome size (raw bases or with K/M/G/T). If specified, will be "
            "used for p-value calculation instead of an estimated size from "
            "k-mer content. Implies -r.",
        ),
        "noncanonical": O(
            O.BOOLEAN,
            "n",
            "Alphabet",
            "Preserve strand (by default, strand is ignored by using "
            "canonical DNA k-mers, which are alphabetical minima of "
            "forward-reverse pairs). Implied if an alphabet is specified "
            "with -a or -z.",
            "",
        ),
        "protein": O(
            O.BOOLEAN,
            "a",
            "Alphabet",
            "Use amino acid alphabet (A-Z, except BJOUXZ). Implies -n, -k 9.",
            "",
        ),
        "alphabet": O(
            O.STRING,
            "z",
            "Alphabet",
            "Alphabet to base hashes on (case ignored by default; see -Z). "
            "K-mers with other characters will be ignored. Implies -n.",
            "",
        ),
        "case": O(
            O.BOOLEAN,
            "Z",
            "Alphabet",
            "Preserve case in k-mers and alphabet (case is ignored by "
            "default). Sequence letters whose case is not in the current "
            "alphabet will be skipped when sketching.",
            "",
        ),
        "threads": O(
            O.INTEGER,
            "p",
            "",
            "Parallelism. This many threads will be spawned for processing.",
            "1",
        ),
        "factor": O(O.NUMBER, "f", "Window", "Compression factor", "100"),
    }


_CATEGORY_ORDER = [
    ("", ""),
    ("Input", "Input"),
    ("Output", "Output"),
    ("Sketch", "Sketching"),
    ("Window", "Sketching (windowed)"),
    ("Reads", "Sketching (reads)"),
    ("Alphabet", "Sketching (alphabet)"),
]


class Command:
    """Base class for subcommands (reference ``Command.h:17-103``)."""

    name = ""
    summary = ""
    description = ""
    argument_string = ""

    def __init__(self):
        self.options: Dict[str, Option] = {}
        self.option_names_by_identifier: Dict[str, str] = {}
        self.arguments: List[str] = []
        self._available = _available_options()

    # -- registry ------------------------------------------------------------

    def add_option(self, name: str, option: Option) -> None:
        self.options[name] = option
        self.option_names_by_identifier[option.identifier] = name

    def use_option(self, name: str) -> None:
        self.add_option(name, self._available[name].copy())

    def use_sketch_options(self) -> None:
        for name in (
            "threads",
            "kmer",
            "noncanonical",
            "protein",
            "alphabet",
            "case",
            "sketchSize",
            "individual",
            "seed",
            "warning",
            "reads",
            "memory",
            "minCov",
            "targetCov",
            "genome",
        ):
            self.use_option(name)

    def get_option(self, name: str) -> Option:
        return self.options[name]

    def has_option(self, name: str) -> bool:
        return name in self.options

    # -- parsing ------------------------------------------------------------

    def parse(self, argv: List[str]) -> int:
        i = 0
        while i < len(argv):
            tok = argv[i]
            if tok.startswith("-") and len(tok) > 1:
                ident = tok[1:]
                if ident not in self.option_names_by_identifier:
                    sys.stderr.write(
                        "ERROR: Unrecognized option: %s\n" % tok
                    )
                    return 1
                option = self.options[
                    self.option_names_by_identifier[ident]
                ]
                option.active = True
                if option.type != Option.BOOLEAN:
                    i += 1
                    if i == len(argv):
                        sys.stderr.write(
                            "ERROR: -%s requires an argument\n"
                            % option.identifier
                        )
                        return 1
                    try:
                        option.set_argument(argv[i])
                    except OptionError as e:
                        return e.code
            else:
                self.arguments.append(tok)
            i += 1
        return self.run()

    def run(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    # -- help ---------------------------------------------------------------

    def print_help(self) -> None:
        """Help text with the reference's column renderer
        (``Command::print``, ``Command.cpp:202-309``)."""
        out = sys.stdout
        out.write("\nVersion: %s\n" % COMPAT_VERSION)
        out.write("\nUsage:\n\n")
        print_columns(
            out,
            [["mash %s [options] %s" % (self.name, self.argument_string)]],
        )
        out.write("Description:\n\n")
        print_columns(out, [[self.description]])
        if not self.options:
            return
        out.write("Options:\n\n")
        col_opt = ["Option"]
        col_desc = ["Description (range) [default]"]
        dividers: List = []
        names_by_cat: Dict[str, List[str]] = {}
        for name, opt in self.options.items():
            names_by_cat.setdefault(opt.category, []).append(name)
        for cat, display in _CATEGORY_ORDER:
            names = names_by_cat.get(cat)
            if not names:
                continue
            if cat:
                dividers.append((len(col_opt), "...%s..." % display))
            for name in names:
                opt = self.options[name]
                left = "-" + opt.identifier
                if opt.type != Option.BOOLEAN:
                    kind = {
                        Option.NUMBER: "num",
                        Option.INTEGER: "int",
                        Option.SIZE: "size",
                        Option.FILE: "path",
                        Option.STRING: "text",
                    }[opt.type]
                    left += " <%s>" % kind
                desc = opt.description
                if opt.argument_min != opt.argument_max:
                    if opt.type == Option.INTEGER:
                        desc += " (%d-%d)" % (
                            int(opt.argument_min),
                            int(opt.argument_max),
                        )
                    else:
                        desc += " (%g-%g)" % (
                            opt.argument_min,
                            opt.argument_max,
                        )
                if opt.argument_default:
                    desc += " [%s]" % opt.argument_default
                col_opt.append(left)
                col_desc.append(desc)
        print_columns(out, [col_opt, col_desc], dividers)


def print_columns(
    out,
    columns: List[List[str]],
    dividers=(),
    indent: int = 2,
    spacing: int = 2,
    missing: str = "-",
    maxw: int = 80,
) -> None:
    """The reference's terminal column renderer
    (``printColumns``, ``Command.cpp:416-539``): per-row columns with
    space-backtracking word wrap at the column offset, column advance
    gated by ``cols - 5``, empty cells rendered as ``missing``, and a
    blank line after every row.  Width is the terminal's, capped at
    ``maxw`` (off-tty the reference reads an uninitialized winsize;
    here the cap applies)."""
    try:
        cols = os.get_terminal_size(0).columns
    except OSError:
        cols = maxw
    if maxw and maxw < cols:
        cols = maxw

    length_maxes = [
        max((len(s) or 1) for s in col) for col in columns
    ]
    div_i = 0
    for i in range(len(columns[0])):
        offset = 0
        offset_target = indent
        if div_i < len(dividers) and i == dividers[div_i][0]:
            out.write(dividers[div_i][1] + "\n\n")
            div_i += 1
        for j, col in enumerate(columns):
            if offset_target > offset:
                out.write(" " * (offset_target - offset))
            text = col[i] if col[i] else missing
            index = 0
            while True:
                length = len(text) - index
                if length + offset_target > cols:
                    length = cols - offset_target
                    while length > 0 and text[index + length] != " ":
                        length -= 1
                if length == 0:
                    length = cols - offset_target
                if length <= 0:  # degenerate terminal; avoid looping
                    length = len(text) - index
                if index > 0:
                    out.write("\n" + " " * offset_target)
                out.write(text[index : index + length])
                index += length
                while index < len(text) and text[index] == " ":
                    index += 1
                if index >= len(text):
                    break
            offset = offset_target + len(col[i])
            if offset_target + length_maxes[j] + spacing > cols - 5:
                if j < len(columns) - 1:
                    out.write("\n")
                offset = 0
            else:
                offset_target += length_maxes[j] + spacing
        out.write("\n\n")


def split_file(path: str) -> List[str]:
    """Read a file of file names (``splitFile``, ``Command.cpp:398-414``)."""
    try:
        with open(path) as f:
            return [ln.rstrip("\n") for ln in f]
    except OSError:
        sys.stderr.write("ERROR: Could not open %s.\n" % path)
        raise OptionError(1)
