"""``sketch_bases_per_s``: bases of the genomes whose sketch was finished
and read back in the window, over the window (host clock)."""


def read(run):
    return run.outcome.bases / run.window_s
