"""``roofline_pct.sketch``: the least time one H100 needs for the
window's sketches over the device's busy time in the traced window, in
percent (:func:`h100_bench.roofline.share_pct`)."""

from h100_bench.roofline import share_pct as read  # noqa: F401
