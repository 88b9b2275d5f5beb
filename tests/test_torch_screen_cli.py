"""``screen`` and ``taxscreen`` of the port against mash_tpu's CLI.

Both CLIs run in-process on the same numpy-seeded inputs and the same DB
sketch, the port with ``MASH_TPU_TORCH_DEVICE=cpu``; stdout and stderr
must be byte-equal.  The cases cover a FASTA mixture, FASTQ reads, a
mixture of at least 4 MiB (the native fast-ingest route), ``-w``,
``-i -1``, ``-v``, stdin, a protein DB (6-frame translation) and
``taxscreen`` with a tiny taxonomy and a mapping file.
"""

import contextlib
import io
import os
import sys

import numpy as np
import pytest

from mash_tpu.__main__ import main as jax_main
from mash_tpu_torch.__main__ import main as torch_main
from mash_tpu_torch.io import capnp_msh

ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MASH_TPU_TORCH_DEVICE", "cpu")
        yield


def _write_fasta(path, records):
    with open(path, "wb") as f:
        for name, seq in records:
            f.write(b">%s\n" % name)
            for j in range(0, len(seq), 70):
                f.write(seq[j : j + 70].tobytes() + b"\n")


def _translate(dna: bytes) -> bytes:
    from mash_tpu_torch.ops.screen_ops import translate_frames

    return translate_frames(np.frombuffer(dna, np.uint8))[0].tobytes()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("screen")
    rng = np.random.default_rng(29)
    genomes = {n: ACGT[rng.integers(0, 4, ln)]
               for n, ln in (("a", 60000), ("b", 40000), ("c", 30000))}
    # b2: a close relative of b, so -w has hashes to reallocate
    b2 = genomes["b"].copy()
    hit = rng.random(len(b2)) < 0.01
    b2[hit] = ACGT[rng.integers(0, 4, int(hit.sum()))]
    genomes["b2"] = b2
    for n, seq in genomes.items():
        _write_fasta(d / ("%s.fa" % n), [(b"%s genome %s" % (n.encode(),
                                                             n.encode()), seq)])

    def reads(n, length, sources):
        out = []
        for i in range(n):
            src = genomes[sources[i % len(sources)]]
            p = int(rng.integers(0, len(src) - length))
            seq = src[p : p + length].copy()
            seq[rng.random(length) < 0.002] = ord("N")
            out.append(seq)
        return out

    _write_fasta(d / "mix.fa", [(b"m%d" % i, s) for i, s in
                                enumerate(reads(400, 150, "aab"))])
    with open(d / "reads.fq", "wb") as f:
        for i, s in enumerate(reads(300, 120, "ab")):
            f.write(b"@q%d\n%s\n+\n%s\n" % (i, s.tobytes(), b"I" * len(s)))
    # >= 4 MiB: the native ingest pipeline
    big = [genomes["a"][: 30000]] * 2 + [ACGT[rng.integers(0, 4, 4_200_000)]]
    _write_fasta(d / "big.fa", [(b"big%d" % i, s) for i, s in enumerate(big)])

    _run(torch_main, ["sketch", "-o", str(d / "db"),
                      *(str(d / ("%s.fa" % n)) for n in ("a", "b", "b2", "c"))])
    # a protein DB: the translation of a's head, screened with its DNA
    _write_fasta(d / "a_head.fa", [(b"a_head", genomes["a"][:9000])])
    prot = _translate(genomes["a"][:9000].tobytes()).replace(b"*", b"K")
    (d / "prot.faa").write_bytes(b">p1 protein\n" + prot + b"\n")
    _run(torch_main, ["sketch", "-a", "-o", str(d / "prot"),
                      str(d / "prot.faa")])
    return d


def _run(main, argv, stdin=None):
    out = io.StringIO()
    old = sys.stdin
    if stdin is not None:
        sys.stdin = io.TextIOWrapper(io.BytesIO(stdin))
    try:
        with contextlib.redirect_stdout(out):
            rc = main(argv)
    finally:
        sys.stdin = old
    assert rc in (0, None), argv
    return out.getvalue()


def _both(capsys, argv, stdin=None):
    """stdout of both CLIs, checked byte-equal (stderr too)."""
    capsys.readouterr()
    want = _run(jax_main, argv, stdin)
    want_err = capsys.readouterr().err
    got = _run(torch_main, argv, stdin)
    got_err = capsys.readouterr().err
    assert got == want
    assert got_err == want_err
    return want


@pytest.mark.parametrize(
    "opts,mixture",
    [([], ["mix.fa"]), ([], ["reads.fq"]), ([], ["big.fa"]),
     (["-w"], ["mix.fa", "reads.fq"]), (["-i", "-1"], ["mix.fa"]),
     (["-i", "-1", "-v", "0.5"], ["reads.fq"])],
    ids=["fasta", "fastq", "fast_ingest", "winner", "identity_all",
         "pvalue"],
)
def test_screen_stdout(inputs, capsys, opts, mixture):
    d = inputs
    out = _both(capsys, ["screen", *opts, str(d / "db.msh"),
                         *(str(d / m) for m in mixture)])
    assert out.strip()
    if opts == ["-i", "-1"]:
        assert "c.fa\tc genome c" in out  # the unshared genome too


def test_screen_stdin(inputs, capsys):
    d = inputs
    out = _both(capsys, ["screen", str(d / "db.msh"), "-"],
                (d / "reads.fq").read_bytes())
    assert out.strip()


def test_screen_protein_db(inputs, capsys):
    d = inputs
    out = _both(capsys, ["screen", str(d / "prot.msh"),
                         str(d / "a_head.fa")])
    assert float(out.split("\t")[0]) > 0.9


def test_taxscreen(inputs, tmp_path, capsys):
    d = inputs
    tax = tmp_path / "tax"
    tax.mkdir()
    (tax / "nodes.dmp").write_text(
        "1\t|\t1\t|\tno rank\t|\n2\t|\t1\t|\tsuperkingdom\t|\n"
        "561\t|\t2\t|\tgenus\t|\n562\t|\t561\t|\tspecies\t|\n"
        "563\t|\t561\t|\tspecies\t|\n5\t|\t1\t|\tgenus\t|\n"
    )
    (tax / "names.dmp").write_text(
        "1\t|\troot\t|\t\t|\tscientific name\t|\n"
        "2\t|\tBacteria\t|\t\t|\tscientific name\t|\n"
        "561\t|\tEscherichia\t|\t\t|\tscientific name\t|\n"
        "562\t|\tEscherichia coli\t|\t\t|\tscientific name\t|\n"
        "563\t|\tEscherichia other\t|\t\t|\tscientific name\t|\n"
        "5\t|\tG\t|\t\t|\tscientific name\t|\n"
    )
    # taxids: a from its comment, b and b2 from the mapping file, c's
    # comment fails extraction ("taxid 5 taxid x") and goes unassigned
    msh = capnp_msh.read_msh(str(d / "db.msh"))
    comments = {"a.fa": "taxid 562", "c.fa": "taxid 5 taxid x"}
    for r in msh.references:
        r.comment = comments.get(os.path.basename(r.name), r.comment)
    db = tmp_path / "tax.msh"
    capnp_msh.write_msh(str(db), msh.params, msh.references)
    mapping = tmp_path / "map.txt"
    mapping.write_text("563\t%s\n562\t%s\n" % (d / "b.fa", d / "b2.fa"))
    out = _both(capsys, ["taxscreen", "-t", str(tax), "-m", str(mapping),
                         str(db), str(d / "mix.fa")])
    names = [ln.split("\t")[-1].strip() for ln in out.splitlines()]
    assert "Escherichia coli" in names and "Escherichia" in names


@pytest.mark.parametrize("command", ["screen", "taxscreen"])
def test_needs_a_card_unless_the_cpu_is_asked_for(inputs, monkeypatch,
                                                  command):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.delenv("MASH_TPU_TORCH_DEVICE")
    d = inputs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_main([command, str(d / "db.msh"), str(d / "mix.fa")])
