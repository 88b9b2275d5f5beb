"""``recompute_row_pct.sketch``: rows recomputed on the plain path for
want of the certificate, as a share of the rows folded, in percent: the
program's counters ``sketch:rows_recomputed`` and ``sketch:rows_folded``
(:func:`h100_bench.program.recompute_pct`)."""

from h100_bench.program import recompute_pct as read  # noqa: F401
