"""``host_wait_pct.sketch``: the share of the window in which the host
waited on the card, in percent: the union of the program's ``wait:*``
stages (:func:`h100_bench.program.wait_pct`)."""

from h100_bench.program import wait_pct as read  # noqa: F401
