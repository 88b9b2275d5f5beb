"""``report_s.screen``: the harness's ``report`` span: the counts read
back, the cardinality, the tallies and each reported sketch's fields."""


def read(run):
    return run.spans.totals.get("report")
