"""Per-record sketching (``-i``) of the port against mash_tpu.

Both packages run on the same numpy-seeded multi-FASTA, the port with
``MASH_TPU_TORCH_DEVICE=cpu``.  ``sketch_records_individual`` must give
the same sketches for records in every pad bucket (4 KiB to 1 MiB; two
rows a launch to keep the CPU's plain path quick) and, with a 4 KiB
engine chunk, for records longer than the chunk, which take the chunked
per-record fold.  Through the CLI, on records of the smaller
buckets and some shorter than k, ``sketch -i`` and ``sketch -i -M`` must
write the same ``.msh`` bytes, and ``dist -i`` and ``triangle`` of the
one file (which implies ``-i``) must print the same bytes.  A file of
records all shorter than k gives the same warning and exit code.
"""

import contextlib
import io

import numpy as np
import pytest

from mash_tpu.__main__ import main as jax_main
from mash_tpu_torch.__main__ import main as torch_main

ACGT = np.frombuffer(b"ACGTACGTACGTACGTacgtN", np.uint8)
# records of the 4 and 16 KiB buckets, some shorter than k, and repeats
# so a bucket holds more than one launch's rows
LENGTHS = [3000, 12000, 15, 900] + [2500] * 18 + [9]
# one record in each bucket of mash_tpu's engine (4 KiB .. 1 MiB)
BUCKET_LENGTHS = [4000, 16000, 60000, 200000, 300000, 1000, 20]


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MASH_TPU_TORCH_DEVICE", "cpu")
        yield


def _write_fasta(path, rng, lengths):
    with open(path, "wb") as f:
        for i, n in enumerate(lengths):
            seq = ACGT[rng.integers(0, len(ACGT), n)]
            f.write(b">ctg%d contig %d of %d\n" % (i, i, n))
            for j in range(0, n, 80):
                f.write(seq[j : j + 80].tobytes() + b"\n")


@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    d = tmp_path_factory.mktemp("indiv")
    rng = np.random.default_rng(61)
    _write_fasta(d / "multi.fa", rng, LENGTHS)
    _write_fasta(d / "other.fa", rng, [4000, 7000, 30])
    _write_fasta(d / "short.fa", rng, [5, 20, 0])
    _write_fasta(d / "buckets.fa", rng, BUCKET_LENGTHS)
    return d


def _run(main, argv):
    """(exit code, stdout, stderr) of one in-process CLI call."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc or 0, out.getvalue(), err.getvalue()


def _sketch_both(d, opts, files, tag):
    got = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        prefix = str(d / ("%s_%s" % (tag, name)))
        rc, _, err = _run(main, ["sketch", *opts, "-o", prefix, *files])
        assert rc == 0, err
        with open(prefix + ".msh", "rb") as f:
            got[name] = (f.read(), err.replace(prefix, "OUT"))
    assert got["jax"] == got["torch"], opts
    return got["torch"]


@pytest.mark.parametrize("opts", [["-i"], ["-i", "-M"], ["-i", "-k", "16"]],
                         ids=["i", "i_M", "i_k16"])
def test_individual_msh_bytes(multi, opts):
    _sketch_both(multi, opts, [str(multi / "multi.fa"),
                               str(multi / "other.fa")], "".join(opts))


@pytest.mark.parametrize(
    "fasta,chunk_len,lengths",
    [("buckets.fa", None, BUCKET_LENGTHS), ("multi.fa", 1 << 12, LENGTHS)],
    ids=["every_bucket", "longer_than_chunk"])
def test_individual_records(multi, fasta, chunk_len, lengths):
    """Records of every bucket, and (with a 4 KiB chunk) records above
    the chunk length, which take ``sketch_seqs`` on both sides; output
    order is input order."""
    from mash_tpu.core import engine as jeng
    from mash_tpu.core.params import default_nucleotide_params as jparams
    from mash_tpu.io.fastx import read_fastx as jread
    from mash_tpu_torch.core import engine as teng
    from mash_tpu_torch.core.params import default_nucleotide_params
    from mash_tpu_torch.io.fastx import read_fastx

    path = str(multi / fasta)
    kw = {"chunk_len": chunk_len} if chunk_len else {}
    want = list(jeng.sketch_records_individual(
        jeng.SketchEngine(jparams(), **kw), jread(path), rows=2))
    stats = {}
    got = list(teng.sketch_records_individual(
        teng.SketchEngine(default_nucleotide_params(), device="cpu", **kw),
        read_fastx(path), rows=2, stats=stats))
    assert stats == {"skipped": True}
    assert [r.name for r in got] == [r.name for r in want]
    assert len(got) == sum(n >= 21 for n in lengths)
    for a, b in zip(got, want):
        assert (a.name, a.comment, a.length) == (b.name, b.comment, b.length)
        np.testing.assert_array_equal(a.hashes, b.hashes)
        np.testing.assert_array_equal(a.counts, b.counts)


def test_individual_all_short_records(multi):
    path = str(multi / "short.fa")
    outs = [_run(main, ["sketch", "-i", "-o", str(multi / "short"), path])
            for main in (jax_main, torch_main)]
    assert outs[0] == outs[1]
    assert outs[1][0] == 1
    assert "shorter than the k-mer size" in outs[1][2]


@pytest.mark.parametrize("argv", [["dist", "-i"], ["triangle"],
                                  ["triangle", "-E"]],
                         ids=["dist_i", "triangle", "triangle_E"])
def test_individual_compare_stdout(multi, argv):
    files = [str(multi / "multi.fa")]
    if argv[0] == "dist":
        files = [str(multi / "other.fa")] + files
    want = _run(jax_main, [*argv, *files])
    got = _run(torch_main, [*argv, *files])
    assert got == want
    assert got[0] == 0 and got[1].strip()
