"""Reads-mode and ``-M`` sketching of the port against mash_tpu's CLI.

Both CLIs run in-process on the same numpy-seeded FASTQ files (reads of
one random genome, half reverse-complemented, with substitutions), the
port with ``MASH_TPU_TORCH_DEVICE=cpu``.  ``sketch`` must write the same
``.msh`` bytes and the same stderr (the genome-size and coverage
estimates, "Reads used" under ``-c``) for ``-r``, ``-r -m 2``, ``-b``,
``-c``, ``-g``, ``-M``, ``-I``/``-C`` on two files, stdin and k = 16.  An
input over ``FAST_INGEST_MIN_BYTES`` takes the order-free ingest route
under ``-r`` and must not under ``-r -m 2``, whose min-copy gate needs
the records in order.
"""

import contextlib
import io
import sys

import numpy as np
import pytest

from mash_tpu.__main__ import main as jax_main
from mash_tpu_torch.__main__ import main as torch_main
from mash_tpu_torch.io.ingest import FAST_INGEST_MIN_BYTES

ACGT = np.frombuffer(b"ACGT", np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MASH_TPU_TORCH_DEVICE", "cpu")
        yield


def _write_reads(rng, path, genome, n, p_sub, length=150, tag=b"r"):
    """FASTQ of n reads of ``genome``: half reverse-complemented, a
    share ``p_sub`` of substitutions, some N."""
    with open(path, "wb") as f:
        for i in range(n):
            p = int(rng.integers(0, len(genome) - length))
            seq = genome[p : p + length].copy()
            hit = rng.random(length) < p_sub
            seq[hit] = ACGT[rng.integers(0, 4, int(hit.sum()))]
            seq[rng.random(length) < 0.001] = ord("N")
            raw = seq.tobytes()
            if i % 2:
                raw = raw.translate(COMP)[::-1]
            f.write(b"@%s%d pos=%d\n%s\n+\n%s\n"
                    % (tag, i, p, raw, b"I" * length))


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("reads")
    rng = np.random.default_rng(41)
    # 9x coverage with few errors, so that -c 5 stops early
    genome = ACGT[rng.integers(0, 4, 20000)]
    _write_reads(rng, d / "r1.fq", genome, 700, 0.002, tag=b"a")
    _write_reads(rng, d / "r2.fq", genome, 500, 0.002, tag=b"b")
    # over the fast-ingest gate: 2 Mbase of reads of a larger genome
    big = ACGT[rng.integers(0, 4, 300000)]
    _write_reads(rng, d / "big.fq", big, 13800, 0.01, tag=b"c")
    assert (d / "big.fq").stat().st_size >= FAST_INGEST_MIN_BYTES
    return d


def _run(main, argv, stdin=None, monkeypatch=None):
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin",
                            io.TextIOWrapper(io.BytesIO(stdin)))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    assert rc in (0, None), (argv, err.getvalue())
    return out.getvalue(), err.getvalue()


def _sketch_both(d, opts, files, tag, stdin=None, monkeypatch=None):
    """The two packages' .msh bytes and stderr (output paths blanked)."""
    got = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        prefix = str(d / ("%s_%s" % (tag, name)))
        _, err = _run(main, ["sketch", *opts, "-o", prefix, *files], stdin,
                      monkeypatch)
        with open(prefix + ".msh", "rb") as f:
            got[name] = (f.read(), err.replace(prefix, "OUT"))
    assert got["jax"] == got["torch"], opts
    return got["torch"]


@pytest.mark.parametrize(
    "opts",
    [["-r"], ["-r", "-m", "2"], ["-b", "1M"], ["-c", "5"],
     ["-g", "5000000"], ["-M"], ["-r", "-I", "x", "-C", "y"],
     ["-r", "-k", "16", "-m", "2", "-M"]],
    ids=["r", "m2", "b1M", "c5", "g5M", "M", "I_C", "k16_m2_M"],
)
def test_reads_msh_and_stderr(reads, opts):
    _, err = _sketch_both(reads, opts, [str(reads / "r1.fq"),
                                        str(reads / "r2.fq")],
                          "_".join(opts).replace("-", ""))
    assert ("Estimated genome size" in err) == (opts != ["-M"])
    assert ("Reads used" in err) == ("-c" in opts)
    if "-c" in opts:  # the target coverage stopped the stream early
        assert 0 < int(err.split("Reads used:")[1].split()[0]) < 1200
    assert "WARNING: -I and -C" not in err


def test_reads_stdin(reads, monkeypatch):
    data = (reads / "r1.fq").read_bytes()
    for opts in (["-r"], ["-r", "-m", "2"]):
        _sketch_both(reads, opts, ["-"], "stdin%d" % len(opts), data,
                     monkeypatch)


@pytest.mark.parametrize("opts", [["-r"], ["-r", "-m", "2"]],
                         ids=["fast", "exact"])
def test_reads_over_fast_ingest_gate(reads, opts):
    from mash_tpu_torch.core import loader
    from mash_tpu_torch.core.params import default_nucleotide_params

    files = [str(reads / "big.fq"), str(reads / "r1.fq")]
    params = default_nucleotide_params()
    params.reads = True
    params.min_cov = 2 if "-m" in opts else 1
    assert loader._fast_ingest_ok(params, files) == (len(opts) == 1)
    _sketch_both(reads, opts, files, "big%d" % len(opts))


def test_exact_stream_keeps_unsigned_hashes(tmp_path):
    """``-M`` keeps every hash of a record with fewer k-mers than s: half
    of them are at least 2^63, and the heap takes their bit patterns."""
    rng = np.random.default_rng(5)
    path = tmp_path / "short.fa"
    path.write_bytes(b">s one\n" + ACGT[rng.integers(0, 4, 400)].tobytes()
                     + b"\n")
    _sketch_both(tmp_path, ["-M"], [str(path)], "short")
    from mash_tpu_torch.io import capnp_msh

    ref = capnp_msh.read_msh(str(tmp_path / "short_torch.msh")).references[0]
    assert len(ref.hashes) == 380
    assert int(ref.hashes.max()) >= 2**63
    assert ref.counts is not None


@pytest.mark.parametrize("opts", [["-r"], ["-r", "-m", "2"], ["-i"], ["-M"]],
                         ids=["r", "m2", "i", "M"])
def test_needs_a_card_unless_the_cpu_is_asked_for(reads, monkeypatch, opts):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.delenv("MASH_TPU_TORCH_DEVICE")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_main(["sketch", *opts, "-o", str(reads / "nocard"),
                    str(reads / "r1.fq")])
