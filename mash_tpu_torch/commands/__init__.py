"""Subcommand implementations (reference ``Command*`` classes)."""

from typing import Callable, Dict

from mash_tpu_torch import NotPortedError

# mash_tpu's commands in the reference's registration order
# (``src/mash/mash.cpp:23-37``); all but ``within`` and ``find`` are
# ported so far.
_ORDER = ("sketch", "dist", "screen", "taxscreen", "triangle", "within",
          "find", "info", "paste", "bounds")


def _not_ported(command_name: str):
    class NotPorted:
        name = command_name
        summary = "(not yet ported in mash_tpu_torch)"

        def parse(self, argv):
            raise NotPortedError("the %s command" % command_name)

    return NotPorted


def command_registry() -> Dict[str, Callable]:
    """name -> Command factory; commands not yet ported exit non-zero
    with a "not yet ported" error."""
    from mash_tpu_torch.commands.bounds import CommandBounds
    from mash_tpu_torch.commands.dist import CommandDistance
    from mash_tpu_torch.commands.info import CommandInfo
    from mash_tpu_torch.commands.paste import CommandPaste
    from mash_tpu_torch.commands.screen import CommandScreen
    from mash_tpu_torch.commands.sketch import CommandSketch
    from mash_tpu_torch.commands.taxscreen import CommandTaxScreen
    from mash_tpu_torch.commands.triangle import CommandTriangle

    ported = {c.name: c for c in (CommandSketch, CommandDistance,
                                  CommandScreen, CommandTaxScreen,
                                  CommandTriangle, CommandInfo,
                                  CommandPaste, CommandBounds)}
    return {n: ported.get(n) or _not_ported(n) for n in _ORDER}
