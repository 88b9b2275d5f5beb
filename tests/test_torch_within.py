"""The port's ``within`` and ``pairwise_containment`` against mash_tpu's.

``pairwise_containment`` runs on the same numpy-seeded sketch rows in
both packages and against the reference's containment walk (a literal
transcription in ``tests/test_containment_oracle.py``): unequal sizes,
empty rows, queries larger than their references, and 32-bit (k <= 16)
hashes with a real 0xFFFFFFFF.  ``within`` runs through both CLIs
in-process (on ``tests/test_within_output.py``'s sketches, among
others), the port with ``MASH_TPU_TORCH_DEVICE=cpu``, and must print the
same stdout (and stderr where it sketches) bytes.  Every output is an
integer or text derived from integers, so the tolerance is equality.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mash_tpu.__main__ import main as jax_main
from mash_tpu.core.params import default_nucleotide_params
from mash_tpu.core.sketch import SketchRef
from mash_tpu.io import capnp_msh
from mash_tpu.ops import distance as jd
from mash_tpu_torch.__main__ import main as torch_main
from mash_tpu_torch.ops import distance as td
from test_containment_oracle import walk
from test_within_output import within_fixture  # noqa: F401  (a fixture)


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MASH_TPU_TORCH_DEVICE", "cpu")
        yield


def _rows(rng, case):
    """(reference rows, query rows): sorted distinct uint64 arrays."""
    if case == "k15_max":
        # 32-bit hashes drawn near the top of their range, 0xFFFFFFFF in
        # most rows of both sides
        universe = np.uint64(0xFFFFFFFF) - rng.choice(
            400, size=120, replace=False).astype(np.uint64)
        universe[0] = np.uint64(0xFFFFFFFF)
    else:
        universe = (rng.choice(300, size=120, replace=False).astype(
            np.uint64) * np.uint64(0x9E3779B97F4A7C15))

    def row(lo, hi):
        m = int(rng.integers(lo, hi + 1))
        pick = universe[rng.choice(len(universe), size=m, replace=False)]
        if case == "k15_max" and rng.random() < 0.7:
            pick = np.unique(np.append(pick, np.uint64(0xFFFFFFFF)))
        return np.sort(np.unique(pick))

    sizes = {"unequal": ((1, 60), (1, 60)), "empty": ((0, 30), (0, 30)),
             "nq_gt_nr": ((3, 15), (35, 60)),
             "k15_max": ((1, 40), (1, 40))}[case]
    refs = [row(*sizes[0]) for _ in range(7)]
    qrys = [row(*sizes[1]) for _ in range(9)]
    if case == "empty":
        refs[2] = refs[2][:0]
        qrys[4] = qrys[4][:0]
    return refs, qrys


@pytest.mark.parametrize("case", ["unequal", "empty", "nq_gt_nr",
                                  "k15_max"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pairwise_containment_matches_mash_tpu(seed, case):
    rng = np.random.default_rng(600 + seed)
    refs, qrys = _rows(rng, case)
    width = max(1, max(len(r) for r in refs + qrys))
    rh, rn = td.pad_sketches(refs, width)
    qh, qn = td.pad_sketches(qrys, width)
    want = [np.asarray(a) for a in jd.pairwise_containment(
        jnp.asarray(rh), jnp.asarray(rn), jnp.asarray(qh), jnp.asarray(qn))]
    R, NR = td._upload(rh, rn, "cpu")
    Q, NQ = td._upload(qh, qn, "cpu")
    # max_elems = one query row against every reference: one chunk a query
    for max_elems in (1 << 24, len(refs) * width):
        got = td.pairwise_containment(R, NR, Q, NQ, max_elems=max_elems)
        assert all(g.dtype == torch.int32 for g in got)
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])
    for i, q in enumerate(qrys):
        for j, r in enumerate(refs):
            assert (want[0][i, j], want[1][i, j]) == walk(r, q), (i, j)


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _both(argv, stderr=False):
    """Run ``argv`` through both CLIs; assert equal output; return it."""
    want = _run(jax_main, argv)
    got = _run(torch_main, argv)
    assert got[:2] == want[:2], argv
    if stderr:
        assert got[2] == want[2], argv
    return want


@pytest.mark.parametrize("threshold", [None, "0.2", "0.0001"])
def test_within_stdout(within_fixture, threshold):
    _refs, _qrys, ref_path, qry_path = within_fixture
    opts = [] if threshold is None else ["-e", threshold]
    rc, out, _ = _both(["within", *opts, ref_path, qry_path])
    # no bound of sketches of at most 1000 reaches 0.0001
    assert rc == 0 and bool(out.strip()) == (threshold != "0.0001")


def test_within_self_containment_rows(within_fixture):
    _refs, _qrys, ref_path, _qry_path = within_fixture
    _rc, out, _ = _both(["within", ref_path, ref_path])
    assert "1\t0.0316228\trefA\trefA\n" in out


def test_within_k15_planted_max(tmp_path):
    """k = 15 sketches whose real hash 0xFFFFFFFF is shared: the port
    must count it as common, as mash_tpu and Mash do."""
    rng = np.random.default_rng(15)
    params = default_nucleotide_params(15, 400, 42)
    top = np.uint64(0xFFFFFFFF)

    def sketch(name, base, extra):
        h = np.unique(np.concatenate([base, extra, [top]]).astype(np.uint64))
        return SketchRef(name=name, comment="", length=100000, hashes=h)

    base = rng.choice(2**32 - 1, size=300, replace=False)
    refs = [sketch("r%d" % i, base[: 200 + 50 * i],
                   rng.integers(0, 2**32 - 1, 100)) for i in range(2)]
    qrys = [sketch("q%d" % i, base[50 * i : 250],
                   rng.integers(0, 2**32 - 1, 150)) for i in range(3)]
    ref_path, qry_path = str(tmp_path / "r.msh"), str(tmp_path / "q.msh")
    capnp_msh.write_msh(ref_path, params, refs)
    capnp_msh.write_msh(qry_path, params, qrys)
    _rc, out, _ = _both(["within", "-e", "1", ref_path, qry_path])
    assert len(out.splitlines()) == 6


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """A reference genome file and two query files: mutated copies and
    unrelated sequence, as multi-record FASTA."""
    d = tmp_path_factory.mktemp("within_fa")
    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genome = acgt[rng.integers(0, 4, 30000)]

    def mutate(seq, p):
        seq = seq.copy()
        hit = rng.random(seq.size) < p
        seq[hit] = acgt[rng.integers(0, 4, int(hit.sum()))]
        return seq.tobytes()

    (d / "ref.fa").write_bytes(b">ref genome\n" + genome.tobytes() + b"\n")
    (d / "q1.fa").write_bytes(
        b">a part\n" + mutate(genome[5000:15000], 0.01) + b"\n"
        b">b part\n" + mutate(genome[:20000], 0.05) + b"\n")
    (d / "q2.fa").write_bytes(
        b">c unrelated\n" + acgt[rng.integers(0, 4, 12000)].tobytes()
        + b"\n>d short\nACGTAC\n")
    return d


def test_within_fasta_reference(fasta):
    """A FASTA reference is sketched first (stderr names it), then the
    queries, each file one sketch."""
    d = fasta
    rc, out, err = _both(["within", "-e", "1", "-s", "2000",
                          str(d / "ref.fa"), str(d / "q1.fa"),
                          str(d / "q2.fa")], stderr=True)
    assert rc == 0 and len(out.splitlines()) == 2
    assert err.startswith("Sketching %s (provide sketch file" % (d / "ref.fa"))


def test_within_individual_queries(fasta):
    d = fasta
    rc, out, _ = _both(["within", "-i", "-e", "1", str(d / "ref.fa"),
                        str(d / "q1.fa"), str(d / "q2.fa")], stderr=True)
    assert rc == 0 and len(out.splitlines()) == 3


def test_within_kmer_refused_on_sketch(within_fixture):
    _refs, _qrys, ref_path, qry_path = within_fixture
    rc, out, err = _both(["within", "-k", "17", ref_path, qry_path],
                         stderr=True)
    assert rc == 1 and not out
    assert "cannot be used when a sketch is provided" in err
