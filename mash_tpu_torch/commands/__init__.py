"""Subcommand implementations (reference ``Command*`` classes)."""

from typing import Callable, Dict


def command_registry() -> Dict[str, Callable]:
    """name -> Command factory, in the reference's registration order
    (``src/mash/mash.cpp:23-37``; within/find are compile-gated there and
    always available here)."""
    from mash_tpu_torch.commands.bounds import CommandBounds
    from mash_tpu_torch.commands.contain import CommandContain
    from mash_tpu_torch.commands.dist import CommandDistance
    from mash_tpu_torch.commands.find import CommandFind
    from mash_tpu_torch.commands.info import CommandInfo
    from mash_tpu_torch.commands.paste import CommandPaste
    from mash_tpu_torch.commands.screen import CommandScreen
    from mash_tpu_torch.commands.sketch import CommandSketch
    from mash_tpu_torch.commands.taxscreen import CommandTaxScreen
    from mash_tpu_torch.commands.triangle import CommandTriangle

    ordered = (CommandSketch, CommandDistance, CommandScreen,
               CommandTaxScreen, CommandTriangle, CommandContain,
               CommandFind, CommandInfo, CommandPaste, CommandBounds)
    return {c.name: c for c in ordered}
