"""``triangle`` of the port against mash_tpu's CLI, and its stripes.

Both CLIs run in-process on the same numpy-seeded ``.msh`` and FASTA
inputs, the port with ``MASH_TPU_TORCH_DEVICE=cpu``; stdout and stderr
must be byte-equal for PHYLIP, ``-E``, ``-C``, ``-v``, ``-d`` and ``-l``.
The port's streamed path (``STREAM_MIN_SKETCHES`` lowered on its side
only) must print what mash_tpu's full-matrix path prints, on partial
sketches and on all-full ones (the uint16 ``common``-only read-back).
``stream_pair_stripes(triangle=True)`` must give the full matrix's lower
triangle, ragged last tiles included.
"""

import contextlib
import io

import numpy as np
import pytest

from mash_tpu.__main__ import main as jax_main
from mash_tpu_torch.__main__ import main as torch_main
from mash_tpu_torch.core.params import default_nucleotide_params
from mash_tpu_torch.core.sketch import SketchRef
from mash_tpu_torch.io import capnp_msh

ACGT = np.frombuffer(b"ACGT", np.uint8)
S = 200


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MASH_TPU_TORCH_DEVICE", "cpu")
        yield


def _sketches(rng, n, full):
    """n sorted sketches drawn from a shared pool (varying overlap, some
    disjoint); all of size S when ``full``, else 40..S."""
    pool = np.unique(rng.integers(0, 2**64 - 1, 4 * S, dtype=np.uint64))
    out = []
    for i in range(n):
        size = S if full else int(rng.integers(40, S + 1))
        if i % 7 == 0:
            h = rng.integers(0, 2**64 - 1, 3 * S, dtype=np.uint64)
        else:
            h = rng.choice(pool, size=2 * S, replace=False)
            priv = rng.random(h.size) < 0.3
            h[priv] = rng.integers(0, 2**64 - 1, int(priv.sum()),
                                   dtype=np.uint64)
        out.append(np.unique(h)[:size])
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tri")
    rng = np.random.default_rng(23)
    params = default_nucleotide_params(21, S, 42)
    for tag, full in (("partial", False), ("full", True)):
        refs = [SketchRef(name="g%02d" % i, comment="c%d" % i,
                          length=int(rng.integers(10**6, 10**7)), hashes=h)
                for i, h in enumerate(_sketches(rng, 45, full))]
        capnp_msh.write_msh(str(d / ("%s.msh" % tag)), params, refs[:30])
        capnp_msh.write_msh(str(d / ("%s2.msh" % tag)), params, refs[30:])
    base = ACGT[rng.integers(0, 4, 30000)]
    for i in range(4):
        g = base.copy()
        hit = rng.random(g.size) < 0.03 * i
        g[hit] = ACGT[rng.integers(0, 4, int(hit.sum()))]
        (d / ("g%d.fa" % i)).write_bytes(b">g%d genome %d\n" % (i, i)
                                         + g.tobytes() + b"\n")
    (d / "list.txt").write_text("%s\n%s\n" % (d / "partial.msh",
                                              d / "partial2.msh"))
    return d


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    assert rc in (0, None), (argv, err.getvalue())
    return out.getvalue(), err.getvalue()


OPTS = [[], ["-E"], ["-C"], ["-v", "0.5"], ["-d", "0.3"], ["-E", "-C"]]
OPT_IDS = ["phylip", "E", "C", "v", "d", "E_C"]


@pytest.mark.parametrize("opts", OPTS, ids=OPT_IDS)
@pytest.mark.parametrize("tag", ["partial", "full"])
def test_triangle_msh(inputs, tag, opts):
    files = [str(inputs / ("%s.msh" % tag)), str(inputs / ("%s2.msh" % tag))]
    want = _run(jax_main, ["triangle", *opts, *files])
    assert _run(torch_main, ["triangle", *opts, *files]) == want
    assert want[0].strip()


@pytest.mark.parametrize("opts", OPTS, ids=OPT_IDS)
@pytest.mark.parametrize("tag", ["partial", "full"])
def test_triangle_streamed(inputs, tag, opts, monkeypatch):
    import mash_tpu_torch.commands.triangle as ttri

    files = [str(inputs / ("%s.msh" % tag)), str(inputs / ("%s2.msh" % tag))]
    want = _run(jax_main, ["triangle", *opts, *files])
    monkeypatch.setattr(ttri, "STREAM_MIN_SKETCHES", 8)
    assert _run(torch_main, ["triangle", *opts, *files]) == want


@pytest.mark.parametrize("opts", [[], ["-E", "-l"]], ids=["fasta", "E_list"])
def test_triangle_fasta_and_list(inputs, opts):
    """Whole FASTA files; a list of the ``.msh`` files."""
    if "-l" in opts:
        files = [str(inputs / "list.txt")]
    else:
        files = [str(inputs / ("g%d.fa" % i)) for i in range(4)]
    want = _run(jax_main, ["triangle", *opts, *files])
    assert _run(torch_main, ["triangle", *opts, *files]) == want
    assert want[0].count("\n") >= 4


@pytest.mark.parametrize("full", [False, True], ids=["partial", "full"])
def test_stream_pair_stripes_triangle(full):
    """Stripes of the lower triangle: columns ``[0, i0 + rows - 1)``,
    equal to the full matrix's cells, with ragged row and column tiles;
    and equal to mash_tpu's stripes."""
    from mash_tpu.ops.distance import stream_pair_stripes as jstripes
    from mash_tpu_torch.ops import distance as td

    rng = np.random.default_rng(7 + full)
    H, N = td.pad_sketches(_sketches(rng, 45, full), S)
    c, d = td.common_denom_tiled(H, N, H, N, S, "cpu")
    want = c.astype(np.uint32) | (d.astype(np.uint32) << 16)
    seen = []
    for i0, stripe in td.stream_pair_stripes(H, N, H, N, S, "cpu",
                                             row_block=8, tile_r=12,
                                             triangle=True):
        rows = min(8, 45 - i0)
        assert stripe.shape == (rows, i0 + rows - 1)
        assert stripe.dtype == np.uint32
        for r in range(rows):
            i = i0 + r
            np.testing.assert_array_equal(stripe[r, :i], want[i, :i])
        seen.append((i0, stripe))
    assert [i0 for i0, _ in seen] == list(range(0, 45, 8))
    ref = list(jstripes(H, N, H, N, S, row_block=8, tile_r=12,
                        triangle=True))
    assert len(ref) == len(seen)
    for (i0, a), (j0, b) in zip(seen, ref):
        assert i0 == j0
        np.testing.assert_array_equal(a, np.asarray(b))


def test_needs_a_card_unless_the_cpu_is_asked_for(inputs, monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.delenv("MASH_TPU_TORCH_DEVICE")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_main(["triangle", str(inputs / "full.msh")])
