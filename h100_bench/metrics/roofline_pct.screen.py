"""``roofline_pct.screen``: the least time one H100 needs for the
window's screen (the mixture's windows and bases, the DB read and its
counts written once) over the device's busy time in the traced window,
in percent (:func:`h100_bench.roofline.share_pct`)."""

from h100_bench.roofline import share_pct as read  # noqa: F401
