"""The port's ingest pipeline ships a file's last batch as its filled rows
only (``mash_tpu_torch.io.ingest.IngestPipeline``).

Every batch but the last holds ``batch_rows`` rows and the last holds the
rows the chunking gives, each batch C-contiguous; the rows are byte-equal
to ``mash_tpu``'s pipeline with its zero padding rows cut, and the cut
rows are counted as ``ingest:padding_rows_cut``.  ``fold_batches`` gives
the same sketch on the trimmed batches as on the same batches padded back
with zero rows, packed and raw, so a caller that still pads stays exact.
Where CUDA is available the batches live in pinned memory, and they are
still writable C-contiguous ``np.ndarray``s of the same bytes.
"""

import numpy as np
import pytest
import torch

from mash_tpu.io.ingest import IngestPipeline as JaxIngestPipeline
from mash_tpu_torch.core.engine import SketchEngine
from mash_tpu_torch.core.params import default_nucleotide_params
from mash_tpu_torch.io.ingest import IngestPipeline, ingest_available
from mash_tpu_torch.utils import profiling

K = 21
L = 256  # a multiple of 32: the packer's vector route
R = 4
STEP = L - (K - 1)

# each case: files, each a list of record lengths
CASES = {
    "shorter_than_a_row": [[100]],
    "ends_mid_batch": [[1000, 500]],
    "whole_batches": [[1000, 907]],  # 1908 bases and a separator: 8 rows
    "several_files": [[300], [1000, 500], [50]],
    "empty_file": [[]],
}


def _file_rows(lengths):
    """Rows of one file: its records joined by one separator byte, cut
    into ``L``-byte rows that overlap by ``K - 1``; a last partial row is
    kept when it holds ``K`` bytes or more."""
    total = sum(lengths) + max(len(lengths) - 1, 0)
    if total < L:
        return int(total >= K)
    full = 1 + (total - L) // STEP
    left = K - 1 + (total - L) - (full - 1) * STEP
    return full + int(left >= K)


def _write(tmp_path, rng, cases):
    paths = []
    for f, lengths in enumerate(cases):
        path = tmp_path / ("f%d.fa" % f)
        with open(path, "wb") as out:
            for r, n in enumerate(lengths):
                seq = np.frombuffer(b"ACGTacgtN", np.uint8)[
                    rng.integers(0, 9, n)].tobytes()
                lines = [seq[i : i + 60] for i in range(0, n, 60)]
                out.write(b">r%d\n%s\n" % (r, b"\n".join(lines)))
        paths.append(str(path))
    return paths


def _batches(cls, paths, chunk_len, rows, pack_mode):
    pipe = cls(paths, K, chunk_len, rows, pack_mode=pack_mode)
    try:
        return list(pipe.batches())
    finally:
        pipe.close()


@pytest.fixture
def native():
    if not ingest_available():
        pytest.skip("native ingest library unavailable")


@pytest.fixture
def timings(monkeypatch):
    monkeypatch.setattr(profiling, "_TIMINGS_ENABLED", True)
    profiling.pop_records()
    yield
    profiling.pop_records()


@pytest.mark.parametrize("pack_mode", [0, 1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_last_batch_holds_its_filled_rows_only(native, timings, tmp_path,
                                               case, pack_mode):
    files = CASES[case]
    paths = _write(tmp_path, np.random.default_rng(7), files)
    got = _batches(IngestPipeline, paths, L, R, pack_mode)
    _spans, counts = profiling.pop_records()
    n = sum(_file_rows(lengths) for lengths in files)
    want_shapes = [R] * (n // R) + ([n % R] if n % R else [])
    assert [b.shape[0] for b in got] == want_shapes
    width = L // 4 + L // 8 if pack_mode else L
    for b in got:
        assert b.shape[1] == width and b.dtype == np.uint8
        assert b.flags.c_contiguous
    cut = (R - n % R) % R
    assert profiling.counter_totals(counts).get(
        "ingest:padding_rows_cut", 0) == cut

    padded = _batches(JaxIngestPipeline, paths, L, R, pack_mode)
    assert len(padded) == len(got)
    if not got:
        return
    padded = np.concatenate(padded)
    assert not padded[n:].any()  # mash_tpu's padding rows are zero
    np.testing.assert_array_equal(np.concatenate(got), padded[:n])


def _pad(batch, rows):
    out = np.zeros((rows, batch.shape[1]), np.uint8)
    out[: batch.shape[0]] = batch
    return out


@pytest.mark.parametrize("pack_mode", [0, 1], ids=["raw", "packed"])
def test_fold_on_trimmed_batches_equals_padded(native, timings, tmp_path,
                                               pack_mode):
    chunk, rows = 4096, 8
    # 40,000 bases in three records: 10 rows, so the last batch holds 2
    paths = _write(tmp_path, np.random.default_rng(8),
                   [[25000, 9000, 5998]])
    trimmed = _batches(IngestPipeline, paths, chunk, rows, pack_mode)
    assert [b.shape[0] for b in trimmed] == [8, 2]
    padded = [_pad(b, rows) for b in trimmed]
    p = default_nucleotide_params(K, 1000, 42)
    refs, folded = [], []
    for batches in (trimmed, padded):
        profiling.pop_records()
        eng = SketchEngine(p, chunk_len=chunk, device="cpu")
        refs.append(eng.state_to_ref(eng.fold_batches(
            eng.empty_state(), batches, packed=bool(pack_mode))))
        _spans, counts = profiling.pop_records()
        folded.append(profiling.counter_totals(counts)["sketch:rows_folded"])
    assert len(refs[0].hashes) == 1000
    np.testing.assert_array_equal(refs[0].hashes, refs[1].hashes)
    np.testing.assert_array_equal(refs[0].counts, refs[1].counts)
    assert folded == [10, 16]  # the padded batches fold their zero rows


@pytest.mark.parametrize("pack_mode", [0, 1, 2])
@pytest.mark.parametrize("cuda", [False, True], ids=["no_cuda", "cuda"])
def test_batches_are_plain_arrays_pinned_where_cuda_is(native, monkeypatch,
                                                       tmp_path, cuda,
                                                       pack_mode):
    """Without CUDA every batch is a plain writable C-contiguous
    ``np.ndarray`` and nothing asks torch to pin; with CUDA (its pinning
    stood in for on the CPU) every batch is a view of a tensor the
    pipeline asked torch to pin.  Either way the rows are byte-equal to
    ``mash_tpu``'s, down to a last batch of filled rows only."""
    pinned = []
    empty = torch.empty

    def recorded_empty(*a, pin_memory=False, **kw):
        t = empty(*a, **kw)
        if pin_memory:
            pinned.append(t)
        return t

    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(torch, "empty", recorded_empty)
    files = CASES["several_files"]
    paths = _write(tmp_path, np.random.default_rng(9), files)
    got = _batches(IngestPipeline, paths, L, R, pack_mode)
    n = sum(_file_rows(lengths) for lengths in files)
    assert [b.shape[0] for b in got] == [R, R, n - 2 * R]
    for b in got:
        assert type(b) is np.ndarray and b.dtype == np.uint8
        assert b.flags.c_contiguous and b.flags.writeable
        assert any(np.shares_memory(b, t.numpy()) for t in pinned) == cuda
    assert bool(pinned) == cuda
    padded = np.concatenate(_batches(JaxIngestPipeline, paths, L, R,
                                     pack_mode))
    np.testing.assert_array_equal(np.concatenate(got), padded[:n])
