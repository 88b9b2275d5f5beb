"""What the benchmark's modules import: nothing of JAX or of the JAX
package anywhere, and in the reference nothing of the program either,
directly or through another module of the benchmark.  Names are
compared whole by their top level: ``mash_tpu_torch`` is the program,
``mash_tpu`` the JAX package."""

import ast
import os

from benchtest_util import ROOT

BENCH_DIR = os.path.join(ROOT, "h100_bench")
FORBIDDEN = {"jax", "jaxlib", "flax", "mash_tpu"}


def modules():
    out = {}
    for folder, _dirs, files in os.walk(BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(folder, f)
                rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
                out[rel.removesuffix(".__init__")] = path
    return out


def imports(path: str) -> set:
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
            names |= {node.module + "." + a.name for a in node.names}
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for mod, path in modules().items():
        tops = {n.split(".")[0] for n in imports(path)}
        assert not tops & FORBIDDEN, (mod, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    mods = modules()
    for start in [m for m in mods if m.startswith("h100_bench.reference")]:
        todo, seen = [start], set()
        while todo:
            m = todo.pop()
            if m in seen:
                continue
            seen.add(m)
            for name in imports(mods[m]):
                top = name.split(".")[0]
                assert top != "mash_tpu_torch", (start, m, name)
                assert top not in FORBIDDEN
                if top == "h100_bench" and name in mods:
                    todo.append(name)
