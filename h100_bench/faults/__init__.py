"""Faults planted underneath a path's timed code, one module a driver
(``faults/<driver>.py``): ``faults()`` returns ``{name: (owner,
attribute, replacement)}``.  Each has to make a run come out as not
correct; ``python3 -m h100_bench.control --fault <name>`` reads one at a
cell's own size on the card, and the CPU tests read each at a small
size."""

import contextlib
import importlib


def of(driver: str) -> dict:
    return importlib.import_module("h100_bench.faults." + driver).faults()


@contextlib.contextmanager
def planted(driver: str, name: str):
    """The fault ``name`` of ``driver`` in place, and taken out after."""
    owner, attr, patched = of(driver)[name]
    saved = getattr(owner, attr)
    setattr(owner, attr, patched)
    try:
        yield
    finally:
        setattr(owner, attr, saved)
