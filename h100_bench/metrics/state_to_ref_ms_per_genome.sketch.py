"""``state_to_ref_ms_per_genome.sketch``: the program's
``engine:state_to_ref`` stage (the certificate settled, the sketch read
back) per call, in milliseconds."""

from h100_bench import program


def read(run):
    w = program.of(run)
    spans = w and program.spans_named(w, "engine:state_to_ref")
    if not spans:
        return None
    return 1e-6 * sum(b - a for _n, _p, a, b in spans) / len(spans)
