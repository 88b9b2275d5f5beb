"""``upload_ms_per_gbase.assembly``: the program's ``transfer:upload``
stage (``Uploader.upload``: the copy into a pinned slot and the start of
the copy to the card) less the ``wait:*`` stages in it (the wait for the
slot) per Gbase sketched, in milliseconds; None where the program has no
such stage."""

from h100_bench import program


def read(run):
    w = program.of(run)
    if not w or not program.spans_named(w, "transfer:upload") \
            or not run.outcome.bases:
        return None
    ns = program.less_waits_ns(w, "transfer:upload")
    return 1e-6 * ns / (run.outcome.bases * 1e-9)
