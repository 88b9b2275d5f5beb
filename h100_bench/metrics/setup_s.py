"""``setup_s``: seconds from the process's start to the window's: the
imports, the data, the program's set-up, builds and warm-up (host clock)."""


def read(run):
    return run.setup_s
