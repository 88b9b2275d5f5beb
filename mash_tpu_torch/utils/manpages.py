"""troff man-page generation from the live command registry.

The counterpart of ``mash_tpu.utils.manpages``: the pages are rendered
from the same :class:`~mash_tpu_torch.cli.command.Command` objects that
drive ``--help``, so names, defaults, ranges and categories can never
drift from the CLI.  A command's page is ``mash_tpu``'s page of that
command, byte for byte; the top page names this package's runtime.

    python -m mash_tpu_torch.utils.manpages <outdir>

writes ``<prog>.1`` and one ``<prog>-<command>.1`` per command into
``<outdir>`` (``prog`` is ``mash-tpu-torch``).
"""

from __future__ import annotations

import os
import sys
from typing import List

from mash_tpu_torch._version import __version__
from mash_tpu_torch.cli.command import _CATEGORY_ORDER, Option

PROG = "mash-tpu-torch"

_KIND = {
    Option.NUMBER: "num",
    Option.INTEGER: "int",
    Option.SIZE: "size",
    Option.FILE: "path",
    Option.STRING: "text",
}


def _esc(text: str) -> str:
    """Escape troff specials (leading dots/quotes, backslashes, dashes
    used as option markers)."""
    out = text.replace("\\", "\\e").replace("-", "\\-")
    if out.startswith(".") or out.startswith("'"):
        out = "\\&" + out
    return out


def _opt_entry(opt: Option) -> List[str]:
    left = "\\fB\\-%s\\fR" % opt.identifier
    if opt.type != Option.BOOLEAN:
        left += " \\fI%s\\fR" % _KIND[opt.type]
    desc = _esc(opt.description)
    if opt.argument_min != opt.argument_max:
        if opt.type == Option.INTEGER:
            desc += " (%d\\-%d)" % (
                int(opt.argument_min), int(opt.argument_max)
            )
        else:
            desc += " (%g\\-%g)" % (
                opt.argument_min, opt.argument_max
            )
    if opt.argument_default:
        desc += " [default: %s]" % _esc(opt.argument_default)
    return [".TP", left, desc]


def render_command_page(cmd_cls, prog: str = PROG) -> str:
    cmd = cmd_cls()
    name = cmd.name
    lines = [
        '.TH "%s-%s" 1 "" "%s %s" "%s Manual"'
        % (prog.upper(), name.upper(), prog, __version__, prog),
        ".SH NAME",
        "%s\\-%s \\- %s" % (prog, name, _esc(cmd.summary)),
        ".SH SYNOPSIS",
        ".B %s %s" % (prog, name),
        "[\\fIoptions\\fR] %s" % _esc(cmd.argument_string),
        ".SH DESCRIPTION",
        _esc(cmd.description),
    ]
    if cmd.options:
        lines.append(".SH OPTIONS")
        by_cat = {}
        for opt in cmd.options.values():
            by_cat.setdefault(opt.category, []).append(opt)
        for cat, display in _CATEGORY_ORDER:
            opts = by_cat.get(cat)
            if not opts:
                continue
            if cat:
                lines.append('.SS "%s"' % _esc(display))
            for opt in opts:
                lines.extend(_opt_entry(opt))
    lines += [
        ".SH SEE ALSO",
        ".BR %s (1)" % prog,
        ".SH REFERENCES",
        'Ondov et al., "Mash: fast genome and metagenome distance '
        'estimation using MinHash", Genome Biology (2016); Ondov et '
        'al., "Mash Screen: high\\-throughput sequence containment '
        'estimation for genome discovery", Genome Biology (2019).',
        "",
    ]
    return "\n".join(lines)


def render_top_page(prog: str = PROG) -> str:
    from mash_tpu_torch.commands import command_registry

    lines = [
        '.TH "%s" 1 "" "%s %s" "%s Manual"'
        % (prog.upper(), prog, __version__, prog),
        ".SH NAME",
        "%s \\- TPU\\-native MinHash sketching for genomic distance, "
        "containment and screening" % prog,
        ".SH SYNOPSIS",
        ".B %s" % prog,
        "\\fIcommand\\fR [\\fIoptions\\fR] [\\fIarguments\\fR]",
        ".SH DESCRIPTION",
        "%s reduces large sequences or sequence sets to compact "
        "bottom\\-s MinHash sketches, then estimates pairwise mutation "
        "distance (Mash distance), containment, and within\\-mixture "
        "identity from sketch intersections \\- with hashing, "
        "sketching, distance and counting kernels running on NVIDIA "
        "GPUs via PyTorch and hand\\-written CUDA.  File formats, "
        "defaults and outputs are byte\\-compatible with Mash 2.3." % prog,
        ".SH COMMANDS",
    ]
    for name, cls in command_registry().items():
        lines += [".TP",
                  "\\fB%s\\fR" % name,
                  _esc(cls.summary)]
    lines += [
        ".TP",
        "\\fB\\-\\-version\\fR",
        "print the compatible Mash version and exit",
        ".TP",
        "\\fB\\-\\-license\\fR",
        "print licensing information",
        ".SH SEE ALSO",
        ", ".join(
            ".BR %s\\-%s (1)" % (prog, n)
            for n in command_registry()
        ),
        "",
    ]
    return "\n".join(lines)


def write_all(outdir: str, prog: str = PROG) -> List[str]:
    from mash_tpu_torch.commands import command_registry

    os.makedirs(outdir, exist_ok=True)
    written = []
    top = os.path.join(outdir, "%s.1" % prog)
    with open(top, "w") as f:
        f.write(render_top_page(prog))
    written.append(top)
    for name, cls in command_registry().items():
        path = os.path.join(outdir, "%s-%s.1" % (prog, name))
        with open(path, "w") as f:
            f.write(render_command_page(cls, prog))
        written.append(path)
    return written


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.stderr.write("usage: python -m mash_tpu_torch.utils.manpages "
                         "<outdir>\n")
        raise SystemExit(2)
    for p in write_all(sys.argv[1]):
        print(p)
