"""The port's windowed sketching (``sketch -W``) and ``find`` against
mash_tpu's.

``SketchEngine.windowed_positions`` runs on the same numpy-seeded bytes in
both packages, at k = 21 and k = 15 (hashed 64-bit all the same), on a
sequence cut into pieces by a small chunk length, with a lowercase
stretch that must be hashed as it is.  ``sketch -W`` must write the same
``.msw`` bytes and ``find`` print the same stdout through both CLIs
in-process, the port with ``MASH_TPU_TORCH_DEVICE=cpu``.  Every output is
an integer or text derived from integers, so the tolerance is equality.
"""

import contextlib
import io
import sys

import numpy as np
import pytest

from mash_tpu.__main__ import main as jax_main
from mash_tpu.core.engine import SketchEngine as JaxEngine
from mash_tpu.core.params import default_nucleotide_params as jax_params
from mash_tpu_torch.__main__ import main as torch_main
from mash_tpu_torch.convert import params_from_numpy
from mash_tpu_torch.core.engine import SketchEngine

ACGT = np.frombuffer(b"ACGT", np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MASH_TPU_TORCH_DEVICE", "cpu")
        yield


@pytest.mark.parametrize("k", [21, 15])
def test_windowed_positions_match_mash_tpu(k):
    """A 30 kb sequence with a lowercase stretch and some N, in pieces of
    a 4 KiB chunk length and whole."""
    rng = np.random.default_rng(k)
    seq = ACGT[rng.integers(0, 4, 30000)]
    seq[rng.random(seq.size) < 0.002] = ord("N")
    seq[9000:13000] += 32  # lowercase: hashed as it is
    seq = seq.tobytes()
    params = jax_params(k, 50, 42)
    params.window_size = 2000
    want = JaxEngine(params, chunk_len=4096).windowed_positions(seq)
    assert len(want[0]) > 100
    for chunk_len in (4096, 1 << 20):
        got = SketchEngine(params_from_numpy(params), chunk_len=chunk_len,
                           device="cpu").windowed_positions(seq)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """A two-record reference (30 kb genome with a lowercase stretch, and
    a 12 kb record named like a query) and queries: a fragment, its
    reverse complement, a mutated fragment, a lowercase fragment, and a
    copy of the reference's second record."""
    d = tmp_path_factory.mktemp("find")
    rng = np.random.default_rng(42)
    genome = ACGT[rng.integers(0, 4, 30000)]
    genome[20000:21000] += 32
    other = ACGT[rng.integers(0, 4, 12000)].tobytes()
    ref = d / "ref.fna"
    with open(ref, "wb") as f:
        f.write(b">chr1 test genome\n")
        for i in range(0, genome.size, 70):
            f.write(genome[i : i + 70].tobytes() + b"\n")
        f.write(b">plasmid second record\n" + other + b"\n")
    g = genome.tobytes()
    q = g[12000:14000].upper()
    mut = np.frombuffer(g[3000:6000].upper(), np.uint8).copy()
    hit = rng.random(mut.size) < 0.02
    mut[hit] = ACGT[rng.integers(0, 4, int(hit.sum()))]
    qry = d / "q.fna"
    qry.write_bytes(
        b">qfwd\n" + q + b"\n>qrev\n" + q.translate(COMP)[::-1]
        + b"\n>qmut\n" + mut.tobytes() + b"\n>qlow\n"
        + g[19500:21500].lower() + b"\n>plasmid\n" + other[2000:9000]
        + b"\n>tiny\nACGT\n")
    return d, str(ref), str(qry)


def _run(main, argv, stdin=None, monkeypatch=None):
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin",
                            io.TextIOWrapper(io.BytesIO(stdin)))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _both(argv, stdin=None, monkeypatch=None):
    want = _run(jax_main, argv, stdin, monkeypatch)
    got = _run(torch_main, argv, stdin, monkeypatch)
    assert got == want, argv
    return want


@pytest.mark.parametrize(
    "opts", [["-L", "1000", "-s", "10"], [], ["-k", "15", "-L", "2000"]],
    ids=["L1000_s10", "defaults", "k15_L2000"])
def test_sketch_w_msw_bytes(synthetic, opts):
    d, ref, _q = synthetic
    msw = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        prefix = str(d / ("w_%s_%s" % ("".join(opts), name)))
        rc, _out, err = _run(main, ["sketch", "-W", *opts, "-o", prefix, ref])
        assert rc == 0 and "Writing to %s.msw" % prefix in err
        msw[name] = open(prefix + ".msw", "rb").read()
    assert msw["jax"] == msw["torch"]


# ``-b`` reaches the sketch options' Bloom-filter size, registered after
# find's own best-hit count (in mash_tpu too), so ``-b 1`` limits nothing
@pytest.mark.parametrize(
    "opts",
    [[], ["-b", "1"], ["-t", "0.01"], ["-self"], ["-L", "1000", "-t", "0.01",
                                                   "-b", "2"]],
    ids=["defaults", "best1", "t001", "self", "L1000_t001_b2"],
)
def test_find_stdout(synthetic, opts):
    _d, ref, qry = synthetic
    rc, out, _ = _both(["find", *opts, ref, qry])
    assert rc == 0
    assert "qfwd\tchr1\t" in out and "qrev\tchr1\t" in out
    assert ("plasmid\tplasmid\t" in out) == ("-self" not in opts)


def test_find_query_on_stdin(synthetic, monkeypatch):
    _d, ref, qry = synthetic
    data = open(qry, "rb").read()
    rc, out, _ = _both(["find", "-L", "1000", ref, "-"], data, monkeypatch)
    assert rc == 0 and "qlow\tchr1\t" in out


def test_find_via_msw_roundtrip(synthetic):
    """find against a ``sketch -W`` .msw prints what find against the
    FASTA prints, in both packages."""
    d, ref, qry = synthetic
    msw = str(d / "refw.msw")
    assert _run(torch_main, ["sketch", "-W", "-L", "1000", "-s", "10", "-o",
                             msw, ref])[0] == 0
    direct = _both(["find", "-L", "1000", "-s", "10", ref, qry])
    assert _both(["find", msw, qry]) == (0, direct[1], "")
    assert direct[1].strip()


def test_find_refuses_msh_and_inherited_options(synthetic):
    d, ref, qry = synthetic
    rc, _out, err = _both(["find", "x.msh", qry])
    assert rc == 1 and "looks like a sketch but is not windowed" in err
    msw = str(d / "refw_k.msw")
    _run(torch_main, ["sketch", "-W", "-o", msw, ref])
    rc, _out, err = _both(["find", "-k", "15", msw, qry])
    assert rc == 1 and "inherited from the sketch" in err
