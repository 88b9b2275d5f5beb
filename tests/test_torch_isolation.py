"""mash_tpu_torch and chip_smoke.py import neither jax nor mash_tpu.

The card's machine has no JAX, and ``mash_tpu/__init__.py`` imports jax
and switches on x64 at import time, so the port keeps its own copies of
everything it needs.  An AST scan finds every import statement; a
subprocess checks what importing the port's entry points really loads.
"""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "mash_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted((ROOT / "mash_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


@pytest.mark.parametrize(
    "path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES]
)
def test_no_forbidden_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, "%s imports %s" % (path, bad)


def test_entry_points_load_no_jax():
    code = (
        "import sys, mash_tpu_torch.__main__, mash_tpu_torch.convert\n"
        "import mash_tpu_torch.utils.transfer\n"
        "from mash_tpu_torch.commands import command_registry\n"
        "command_registry()\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'mash_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
