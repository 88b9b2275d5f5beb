"""``settle_ms_per_batch.assembly``: the program's ``engine:settle``
stage (``sketch_ops.fold_batch`` merging in the previous batch's rows
without the certificate, the wait for their mask included) over the
``engine:fold_batch`` stages, in milliseconds a batch; None where the
program has no such stage."""

from h100_bench import program


def read(run):
    w = program.of(run)
    settle = w and program.spans_named(w, "engine:settle")
    if not settle:
        return None
    batches = len(program.spans_named(w, "engine:fold_batch"))
    return 1e-6 * sum(b - a for _n, _p, a, b in settle) / batches
