"""``fold_dispatch_self_ms_per_gbase.sketch``: the program's
``engine:fold_batch`` stage less the ``wait:*`` stages in it (the host
blocked on the card) per Gbase sketched, in milliseconds."""

from h100_bench import program


def read(run):
    w = program.of(run)
    if not w or not program.spans_named(w, "engine:fold_batch") \
            or not run.outcome.bases:
        return None
    ns = program.less_waits_ns(w, "engine:fold_batch")
    return 1e-6 * ns / (run.outcome.bases * 1e-9)
