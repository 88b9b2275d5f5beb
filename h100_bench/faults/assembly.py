"""Faults of the assembly path: the sketch path's own, planted in
``SketchEngine`` (:mod:`h100_bench.faults.sketch`).  On an assembly's
full batches ``half_batch`` folds 16 of each batch's 32 rows."""

from h100_bench.faults.sketch import faults  # noqa: F401
