"""``device_idle_pct.screen``: the share of the traced window in which no
operation ran on the card (``torch.profiler``), in percent
(:func:`h100_bench.trace.idle_pct`)."""

from h100_bench.trace import idle_pct as read  # noqa: F401
