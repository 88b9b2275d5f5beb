"""``fold_self_ms_per_genome.sketch``: the self time of the program's
``engine:fold_batches`` stage (``SketchEngine.fold_batches`` less its
``engine:fold_batch`` stages: the scan for the padding rows) per call,
one a genome, in milliseconds."""

from h100_bench import program


def read(run):
    w = program.of(run)
    n = w and len(program.spans_named(w, "engine:fold_batches"))
    if not n:
        return None
    return 1e-6 * program.self_ns(w, "engine:fold_batches") / n
