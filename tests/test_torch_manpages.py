"""The port's man pages against mash_tpu's rendering.

``mash_tpu_torch.utils.manpages`` renders from the port's command
registry: each command's page must equal ``mash_tpu``'s page of the same
command byte for byte, under either program name; the top page differs
only in naming the runtime, and lists the ten commands.  Pages written by
``write_all`` pass the troff escaping check of ``tests/test_manpages.py``.
"""

import os

import pytest

from mash_tpu.commands import command_registry as jax_registry
from mash_tpu.utils import manpages as jax_pages
from mash_tpu_torch.commands import command_registry
from mash_tpu_torch.utils import manpages

COMMANDS = ("sketch", "dist", "screen", "taxscreen", "triangle", "within",
            "find", "info", "paste", "bounds")


def test_registry_order():
    assert tuple(command_registry()) == tuple(jax_registry()) == COMMANDS


@pytest.mark.parametrize("prog", ["mash-tpu", "mash-tpu-torch"])
@pytest.mark.parametrize("name", COMMANDS)
def test_command_page_equals_mash_tpu(name, prog):
    got = manpages.render_command_page(command_registry()[name], prog)
    want = jax_pages.render_command_page(jax_registry()[name], prog)
    assert got == want


def test_top_page():
    got = manpages.render_top_page("mash-tpu")
    want = jax_pages.render_top_page("mash-tpu").replace(
        "running on TPU via JAX/XLA/Pallas.  File",
        "running on NVIDIA GPUs via PyTorch and hand\\-written CUDA.  File")
    assert got == want
    top = manpages.render_top_page()
    for name in COMMANDS:
        assert "\\fB%s\\fR" % name in top
        assert ".BR mash-tpu-torch\\-%s (1)" % name in top


def test_troff_escaping(tmp_path):
    written = manpages.write_all(str(tmp_path))
    assert sorted(os.path.basename(p) for p in written) == sorted(
        ["mash-tpu-torch.1"] + ["mash-tpu-torch-%s.1" % n for n in COMMANDS])
    # no unescaped leading dots that troff would eat as macros
    for fn in os.listdir(tmp_path):
        for line in open(os.path.join(tmp_path, fn)):
            if line.startswith(".") and not line.split()[0][1:].isupper():
                allowed = {".TP", ".SS", ".SH", ".TH", ".B", ".BR"}
                assert line.split()[0] in allowed or line.startswith(
                    ".\\\""
                ), (fn, line)
