"""The port's main path (``sketch`` -> ``dist``) against mash_tpu's CLI.

Both CLIs run in-process on the same numpy-seeded FASTA files, the port
with ``MASH_TPU_TORCH_DEVICE=cpu``.  ``sketch`` must write the same
``.msh`` bytes — including for an input of at least 4 MiB, which takes
the native ingest route — and ``dist`` (plain, ``-t``, ``-C``, with
thresholds) must print the same bytes.
"""

import contextlib
import io
import sys

import numpy as np
import pytest

from mash_tpu.__main__ import main as jax_main
from mash_tpu_torch.__main__ import main as torch_main


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MASH_TPU_TORCH_DEVICE", "cpu")
        yield


def _fasta(rng, path, records, mut_of=None, p_mut=0.0):
    """Write records of random ACGT (some lowercase and N); with
    ``mut_of`` each record is a mutated copy of that sequence list."""
    seqs = []
    with open(path, "wb") as f:
        for i, n in enumerate(records):
            if mut_of is not None:
                seq = mut_of[i].copy()
                hit = rng.random(len(seq)) < p_mut
                seq[hit] = np.frombuffer(b"ACGT", np.uint8)[
                    rng.integers(0, 4, int(hit.sum()))]
            else:
                seq = np.frombuffer(b"ACGTACGTACGTACGTacgtN", np.uint8)[
                    rng.integers(0, 21, n)]
            seqs.append(seq)
            f.write(b">rec%d description %d\n" % (i, n))
            for j in range(0, len(seq), 70):
                f.write(seq[j : j + 70].tobytes() + b"\n")
    return seqs


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(17)
    base = _fasta(rng, d / "a.fa", [30000, 9000, 15])
    _fasta(rng, d / "b.fa", [30000, 9000, 15], base, 0.02)
    _fasta(rng, d / "c.fa", [20000, 4000], None)
    # >= 4 MiB: takes the native ingest pipeline (fast path)
    _fasta(rng, d / "big.fa", [2_200_000, 2_100_000])
    (d / "list.txt").write_text("%s\n%s\n" % (d / "b.fa", d / "c.fa"))
    return d


def _run(main, argv, stdin=None, monkeypatch=None):
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin",
                            io.TextIOWrapper(io.BytesIO(stdin)))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    assert rc in (0, None), argv
    return out.getvalue()


def _sketch_both(d, opts, files, tag):
    paths = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        prefix = str(d / ("%s_%s" % (tag, name)))
        _run(main, ["sketch", *opts, "-o", prefix, *files])
        paths[name] = prefix + ".msh"
    with open(paths["jax"], "rb") as a, open(paths["torch"], "rb") as b:
        assert a.read() == b.read(), opts
    return paths


@pytest.fixture(scope="module")
def sketches(inputs):
    """Default sketches of a, b, c by both packages (checked equal)."""
    d = inputs
    return _sketch_both(d, [], [str(d / "a.fa"), str(d / "b.fa"),
                                str(d / "c.fa")], "default")


@pytest.mark.parametrize(
    "opts",
    [["-k", "16", "-n", "-S", "7"], ["-a"],
     ["-z", "ACGTN", "-k", "12", "-Z", "-s", "300"]],
    ids=["k16_n_S7", "protein", "alphabet_Z_s300"],
)
def test_sketch_msh_bytes(inputs, sketches, opts):
    d = inputs
    _sketch_both(d, opts, [str(d / "a.fa"), str(d / "b.fa"),
                           str(d / "c.fa")], "opt%d" % len(opts))


def test_sketch_fast_ingest_and_list(inputs):
    d = inputs
    _sketch_both(d, [], [str(d / "big.fa"), str(d / "a.fa")], "big")
    _sketch_both(d, ["-l"], [str(d / "list.txt")], "list")


def test_sketch_stdin(inputs, monkeypatch):
    d = inputs
    data = (d / "b.fa").read_bytes()
    outs = []
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        prefix = str(d / ("stdin_%s" % name))
        _run(main, ["sketch", "-o", prefix, "-"], data, monkeypatch)
        outs.append(open(prefix + ".msh", "rb").read())
    assert outs[0] == outs[1]


@pytest.mark.parametrize(
    "opts",
    [[], ["-t"], ["-C"], ["-d", "0.05", "-v", "1e-10"]],
    ids=["plain", "table", "comment", "thresholds"],
)
def test_dist_stdout(sketches, opts):
    paths = sketches
    want = _run(jax_main, ["dist", *opts, paths["jax"], paths["jax"]])
    got = _run(torch_main, ["dist", *opts, paths["torch"], paths["torch"]])
    assert got == want
    assert want.strip()


def test_dist_of_sequence_files(inputs):
    """dist sketches FASTA inputs itself."""
    d = inputs
    files = [str(d / "a.fa"), str(d / "b.fa"), str(d / "c.fa")]
    want = _run(jax_main, ["dist", "-C", *files])
    assert _run(torch_main, ["dist", "-C", *files]) == want


def test_dist_streamed_path(sketches, monkeypatch):
    import mash_tpu.commands.dist as jdist
    import mash_tpu_torch.commands.dist as tdist

    paths = sketches
    monkeypatch.setattr(jdist, "STREAM_MIN_CELLS", 10**12)
    want = _run(jax_main, ["dist", paths["jax"], paths["jax"]])
    monkeypatch.setattr(tdist, "STREAM_MIN_CELLS", 2)
    got = _run(torch_main, ["dist", paths["torch"], paths["torch"]])
    assert got == want
