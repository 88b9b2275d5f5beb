"""``db_build_s``: the harness's ``db_build`` span in set-up:
``build_db_table`` on the host and the counter's K4 table on the card."""


def read(run):
    return run.spans.totals.get("db_build")
