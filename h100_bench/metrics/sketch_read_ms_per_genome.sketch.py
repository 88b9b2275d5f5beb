"""``sketch_read_ms_per_genome.sketch``: the harness's ``read_sketch``
span (``state_to_ref``: the wait for the card, the certificate settled,
the read-back) per genome, in milliseconds."""


def read(run):
    n = run.spans.calls.get("read_sketch")
    if not n:
        return None
    return 1e3 * run.spans.totals["read_sketch"] / n
