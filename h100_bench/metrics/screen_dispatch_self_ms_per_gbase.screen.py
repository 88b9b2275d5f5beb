"""``screen_dispatch_self_ms_per_gbase.screen``: the program's
``screen:fold_batch`` stage less the ``wait:*`` stages in it (the host
blocked on the card) per Gbase streamed, in milliseconds."""

from h100_bench import program


def read(run):
    w = program.of(run)
    if not w or not program.spans_named(w, "screen:fold_batch") \
            or not run.outcome.bases:
        return None
    ns = program.less_waits_ns(w, "screen:fold_batch")
    return 1e-6 * ns / (run.outcome.bases * 1e-9)
