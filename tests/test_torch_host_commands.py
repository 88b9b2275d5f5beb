"""``info``, ``paste`` and ``bounds`` of the port against mash_tpu's CLI.

Both CLIs run in-process on the same sketch files, written by
mash_tpu from numpy-seeded FASTA (with and without ``-M``, and a
windowed ``.msw``); stdout, stderr, exit codes and the ``.msh`` bytes
that ``paste`` writes must be equal.  mash_tpu's ``bounds`` scans x one
scalar binomial CDF at a time (minutes a table); here it reads the same
values from a cache filled by vectorized calls, which return them bit
for bit.
"""

import contextlib
import io

import numpy as np
import pytest
from scipy.stats import binom

from mash_tpu.__main__ import main as jax_main
from mash_tpu_torch.__main__ import main as torch_main

ACGT = np.frombuffer(b"ACGTACGTacgtN", np.uint8)


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MASH_TPU_TORCH_DEVICE", "cpu")
        yield


def _run(main, argv):
    """(exit code, stdout, stderr) of one in-process CLI call."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc or 0, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def sketches(tmp_path_factory):
    d = tmp_path_factory.mktemp("host")
    rng = np.random.default_rng(13)
    for name, lengths in (("a", [20000, 5000]), ("b", [12000]),
                          ("c", [8000, 3000, 900])):
        with open(d / ("%s.fa" % name), "wb") as f:
            for i, n in enumerate(lengths):
                f.write(b">%s%d some comment\n" % (name.encode(), i)
                        + ACGT[rng.integers(0, len(ACGT), n)].tobytes()
                        + b"\n")
    for argv in (["-o", "a", "a.fa"], ["-o", "b", "b.fa"],
                 ["-i", "-o", "c", "c.fa"], ["-M", "-o", "m", "a.fa"],
                 ["-W", "-o", "w", "c.fa"]):
        argv = [str(d / x) if x.endswith(".fa") or x in "abcmw" else x
                for x in argv]
        assert _run(jax_main, ["sketch", *argv])[0] == 0
    (d / "list.txt").write_text("%s\n%s\n" % (d / "b.msh", d / "c.msh"))
    return d


@pytest.mark.parametrize(
    "argv",
    [["info"], ["info", "-H"], ["info", "-t"], ["info", "-d"],
     ["info", "-c"], ["info", "-c", "m"], ["info", "-H", "-t"],
     ["info", "-d", "-c"], ["info", "w"], ["info", "-t", "w"],
     ["info", "x.fa"]],
    ids=["plain", "H", "t", "d", "c_nocounts", "c", "H_t", "d_c", "msw",
         "msw_t", "not_sketch"],
)
def test_info(sketches, argv):
    d = sketches
    name = argv.pop() if argv[-1] in ("m", "w", "x.fa") else "c"
    path = {"m": "m.msh", "w": "w.msw", "c": "c.msh", "x.fa": "a.fa"}[name]
    argv = [*argv, str(d / path)]
    want = _run(jax_main, argv)
    assert _run(torch_main, argv) == want
    assert want[1] or want[2]


@pytest.mark.parametrize("opts", [[], ["-l"]], ids=["files", "list"])
def test_paste(sketches, opts):
    d = sketches
    inputs = ([str(d / "list.txt")] if opts else
              [str(d / "a.msh"), str(d / "b.msh"), str(d / "c.msh")])
    out = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        prefix = str(d / ("paste%s_%s" % ("".join(opts), name)))
        rc, so, se = _run(main, ["paste", *opts, prefix, *inputs])
        assert rc == 0
        with open(prefix + ".msh", "rb") as f:
            out[name] = (f.read(), so, se.replace(prefix, "OUT"))
        # a second paste to the same prefix refuses to overwrite it
        again = _run(main, ["paste", *opts, prefix, *inputs])
        out[name] += (again[0], again[2].replace(prefix, "OUT"))
    assert out["jax"] == out["torch"]
    assert out["torch"][3] == 1


def test_paste_rejects_non_sketch(sketches):
    argv = ["paste", str(sketches / "bad"), str(sketches / "a.fa")]
    assert _run(torch_main, argv) == _run(jax_main, argv)


class _CachedCdf:
    """``binomial_cdf(x, p, n)`` from vectorized ``binom.cdf`` blocks."""

    def __init__(self):
        self.cache = {}

    def __call__(self, x, p, n):
        got = self.cache.get((p, n), np.empty(0))
        while x >= got.size:
            xs = np.arange(got.size, min(n + 1, max(2 * got.size, 4096)))
            got = self.cache[(p, n)] = np.concatenate(
                [got, binom.cdf(xs, n, p)])
        return float(got[x])


def test_cached_cdf_is_bitwise_scalar():
    cdf = _CachedCdf()
    for n, p in ((1000, 0.21), (100000, 0.0071), (1000000, 0.34)):
        for x in (0, 7, 300, n // 3, n - 1):
            assert cdf(x, p, n) == float(binom.cdf(x, n, p))


@pytest.mark.parametrize("opts", [[], ["-k", "16", "-p", "0.9"]],
                         ids=["default", "k16_p09"])
def test_bounds(opts, monkeypatch):
    import mash_tpu.commands.bounds as jbounds

    monkeypatch.setattr(jbounds, "binomial_cdf", _CachedCdf())
    want = _run(jax_main, ["bounds", *opts])
    assert _run(torch_main, ["bounds", *opts]) == want
    assert "Mash distance" in want[1]
