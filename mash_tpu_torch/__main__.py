"""Top-level CLI dispatch (reference ``mash.cpp`` + ``CommandList.cpp``).

Usage: ``python -m mash_tpu_torch <command> [options]`` or the
``mash-tpu-torch`` console script.  Commands run on ``cuda`` unless
``MASH_TPU_TORCH_DEVICE=cpu`` asks for the CPU.  A multi-process launch
sets ``MASH_TPU_TORCH_COORDINATOR``, ``MASH_TPU_TORCH_NUM_PROCESSES`` and
``MASH_TPU_TORCH_PROCESS_ID`` in every process (or runs under
``torchrun``).
"""

from __future__ import annotations

import sys

from mash_tpu_torch._version import COMPAT_VERSION, __version__
from mash_tpu_torch.commands import command_registry


def print_top_level_help(commands) -> None:
    out = sys.stdout
    out.write("\n")
    out.write("mash-tpu-torch %s (Mash %s compatible; PyTorch/CUDA)\n" % (
        __version__, COMPAT_VERSION))
    out.write("\n")
    out.write("Type 'mash-tpu-torch --license' for license and copyright "
              "information.\n")
    out.write("\n")
    out.write("Usage:\n\n")
    out.write("   mash-tpu-torch <command> [options] [arguments ...]\n\n")
    out.write("Commands:\n\n")
    width = max(len(name) for name in commands) + 3
    for name, cls in commands.items():
        out.write("   %-*s%s\n" % (width, name, cls.summary))
    out.write("\n")


def print_license() -> None:
    sys.stdout.write(
        "mash-tpu-torch: a from-scratch PyTorch/CUDA reimplementation of the "
        "capabilities of\nMash %s (https://github.com/marbl/Mash). "
        "Mash itself is distributed under the\nBNBI license; this "
        "implementation shares no code with it.\n" % COMPAT_VERSION
    )


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    # join the process group a multi-process launch describes (see
    # parallel/multihost.py); a no-op for a plain run
    from mash_tpu_torch.parallel.multihost import maybe_init_distributed

    maybe_init_distributed()
    commands = command_registry()

    if not argv:
        print_top_level_help(commands)
        return 0
    if argv[0] == "--version":
        sys.stdout.write("%s\n" % COMPAT_VERSION)
        return 0
    if argv[0] == "--license":
        print_license()
        return 0
    if argv[0] not in commands:
        sys.stderr.write("ERROR: Unrecognized command: '%s'\n" % argv[0])
        print_top_level_help(commands)
        return 1

    command = commands[argv[0]]()
    try:
        from mash_tpu_torch.utils import maybe_trace, stage

        with maybe_trace(), stage("command:%s" % argv[0]):
            return command.parse(argv[1:])
    except BrokenPipeError:
        return 0
    except Exception as e:
        from mash_tpu_torch.io.capnp_msh import CorruptMshError

        if isinstance(e, CorruptMshError):
            # damaged .msh inputs get a diagnostic instead of a
            # traceback (the reference exits via a capnp exception)
            sys.stderr.write("ERROR: %s\n" % e)
            return 1
        if not isinstance(e, OSError):
            raise
        # the reference reports unreadable inputs with cerr + exit(1)
        # (e.g. Sketch.cpp:195-199, CommandFind.cpp:131); claim
        # "for reading" for the read-path errnos incl. EACCES (the
        # common unreadable-input case) — write-side ENOSPC etc. get
        # the generic message
        import errno

        name = getattr(e, "filename", None)
        if name and e.errno in (
            errno.ENOENT,
            errno.EACCES,
            errno.EISDIR,
            errno.ENOTDIR,
        ):
            sys.stderr.write(
                "ERROR: could not open %s for reading.\n" % name
            )
        else:
            sys.stderr.write("ERROR: %s\n" % e)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
