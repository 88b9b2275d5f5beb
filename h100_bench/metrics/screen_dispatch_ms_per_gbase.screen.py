"""``screen_dispatch_ms_per_gbase.screen``: the program's
``screen:fold_batch`` stage (hash, count and fold dispatched) per Gbase
streamed, in milliseconds."""


def read(run):
    s = run.stages.get("screen:fold_batch")
    if s is None or not run.outcome.bases:
        return None
    return 1e3 * s / (run.outcome.bases * 1e-9)
