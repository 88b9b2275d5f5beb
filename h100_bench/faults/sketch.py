"""Faults of the sketch path, planted in ``SketchEngine``."""


def _filled(batch) -> int:
    """The batch's rows up to its last that holds data (the ingest pads a
    file's last batch with zero rows)."""
    rows = batch.shape[0]
    while rows > 1 and not batch[rows - 1].any():
        rows -= 1
    return rows


def faults() -> dict:
    from mash_tpu_torch.core.engine import SketchEngine

    fold, read = SketchEngine.fold_batches, SketchEngine.state_to_ref

    def unchanged(self, state, batches, packed=False):
        return state

    def half(self, state, batches, packed=False):
        # half of the rows that hold data: a genome fills a few of a
        # batch's rows, and the rest is padding
        return fold(self, state, [b[: max(1, _filled(b) // 2)]
                                  for b in batches], packed)

    def altered(self, state, *a, **kw):
        ref = read(self, state, *a, **kw)
        ref.hashes[0] ^= 1
        return ref

    return {"state_unchanged": (SketchEngine, "fold_batches", unchanged),
            "half_batch": (SketchEngine, "fold_batches", half),
            "answer_altered": (SketchEngine, "state_to_ref", altered)}
