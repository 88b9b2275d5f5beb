"""``screen_bases_per_s``: mixture bases streamed in the window, over the
window, which ends with the report (host clock)."""


def read(run):
    return run.outcome.bases / run.window_s
