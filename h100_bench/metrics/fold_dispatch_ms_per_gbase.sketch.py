"""``fold_dispatch_ms_per_gbase.sketch``: the program's
``engine:fold_batch`` stage (the dispatch of uploads and folds) per Gbase
sketched, in milliseconds."""


def read(run):
    s = run.stages.get("engine:fold_batch")
    if s is None or not run.outcome.bases:
        return None
    return 1e3 * s / (run.outcome.bases * 1e-9)
