"""Faults of the screen path, planted in the fold that
``screen_ops.make_screen_fold`` returns."""


def faults() -> dict:
    from mash_tpu_torch.ops import screen_ops

    make = screen_ops.make_screen_fold

    def wrap(change):
        def patched(*a, **kw):
            return change(*make(*a, **kw))
        return patched

    def unchanged(fold, fold_rows, counts, finalize):
        return fold, (lambda c, s, rows: (c, s)), counts, finalize

    def half(fold, fold_rows, counts, finalize):
        # the driver has cut the padding rows: these all hold reads
        return (fold, lambda c, s, rows: fold_rows(
            c, s, rows[: max(1, rows.shape[0] // 2)]), counts, finalize)

    def altered(fold, fold_rows, counts, finalize):
        def wrong(c):
            out = finalize(c).copy()
            out[0] += 1
            return out
        return fold, fold_rows, counts, wrong

    return {name: (screen_ops, "make_screen_fold", wrap(f))
            for name, f in (("state_unchanged", unchanged),
                            ("half_batch", half), ("answer_altered", altered))}
