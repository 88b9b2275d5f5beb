"""mash_tpu_torch's CUDA kernels against their plain versions on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` (the kernels are built
at first use) and carries the ``cuda`` marker; without a card the
``gpu`` fixture skips it.  Run on a GPU machine, which needs no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_gpu.py

Each kernel and its plain version run on the same CUDA tensors and must
agree exactly (every output is an integer), at edge shapes that
``chip_smoke.py``'s main-path shapes do not reach: a ragged last subrow,
k at 1 and 32, the protein alphabet, uneven pair grids, sizes that are
not powers of two, a cap below the sketch size, and rows too wide for
shared memory.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from mash_tpu_torch.core.params import (
    ALPHABET_PROTEIN,
    SketchParams,
    default_nucleotide_params,
)
from mash_tpu_torch.ops import distance as td
from mash_tpu_torch.ops import pairwise_kernel as pk
from mash_tpu_torch.ops import sketch_kernel as sk
from mash_tpu_torch.ops.kmers import alphabet_bytes

pytestmark = pytest.mark.cuda

DNA = alphabet_bytes(default_nucleotide_params().alphabet)
EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)


def _protein():
    p = SketchParams()
    p.set_alphabet(ALPHABET_PROTEIN)
    return alphabet_bytes(p.alphabet)


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _seq(seed, symbols, shape):
    rng = np.random.default_rng(seed)
    return rng.choice(np.frombuffer(symbols, dtype=np.uint8), size=shape)


@pytest.mark.parametrize(
    "k,use64,noncanon,preserve,length",
    [(21, True, False, False, 40000), (21, True, True, False, 50001),
     (16, False, False, False, 40000), (1, False, False, True, 9000),
     (32, True, False, False, 2 * sk.C + 31), (9, False, True, True, 70000)],
)
def test_sketch_select_matches_plain(gpu, k, use64, noncanon, preserve,
                                     length):
    x = torch.from_numpy(_seq(k + length, b"ACGTacgtNn\x00", (3, length)))
    x = x.to(gpu)
    kw = dict(alphabet=DNA, k=k, seed=42, use64=use64,
              noncanonical=noncanon, preserve_case=preserve)
    for m in (16, 64):
        got = sk.sketch_select(x, **kw, m=m)
        want = sk.sketch_select_plain(x, **kw, m=m)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), (k, m)


def test_sketch_select_protein(gpu):
    alpha = _protein()
    x = torch.from_numpy(
        _seq(3, b"ACDEFGHIKLMNPQRSTVWYXacd*", (2, 30000))).to(gpu)
    kw = dict(alphabet=alpha, k=9, seed=42, use64=True, noncanonical=True,
              preserve_case=False)
    got = sk.sketch_select(x, **kw, m=32)
    want = sk.sketch_select_plain(x, **kw, m=32)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["random", "repetitive", "mixed", "empty"])
def test_sketch_chunks_fused_matches_plain(gpu, case):
    rand = _seq(9, b"ACGTacgtN", (2, 60000))
    rep = np.tile(np.frombuffer(b"AT", np.uint8), 30000)[None].repeat(2, 0)
    arr = {"random": rand, "repetitive": rep,
           "mixed": np.stack([rand[0], rep[0]]),
           "empty": np.zeros((2, 60000), np.uint8)}[case]
    x = torch.from_numpy(np.ascontiguousarray(arr)).to(gpu)
    before = sk.LAUNCHES["sketch_select"]
    for k, use64 in ((21, True), (15, False)):
        kw = dict(alphabet=DNA, k=k, seed=42, use64=use64,
                  noncanonical=False, preserve_case=False)
        H, C = sk.sketch_chunks_fused(x, **kw, s=100)
        Hp, Cp = sk.sketch_chunks_plain(x, **kw, s=100)
        assert torch.equal(H, Hp) and torch.equal(C, Cp), k
    assert sk.LAUNCHES["sketch_select"] == before + 2


@pytest.mark.parametrize("s", [5000, 10000])
def test_sketch_chunks_fused_large_s(gpu, s):
    """Sketch sizes whose candidate budget exceeds the TPU kernel's
    3m + 2 <= 128 output still launch the kernel on 1 MiB chunks."""
    x = torch.from_numpy(_seq(s, b"ACGTacgtN", (2, 1 << 20))).to(gpu)
    kw = dict(alphabet=DNA, k=21, seed=42, use64=True, noncanonical=False,
              preserve_case=False)
    assert 3 * sk.candidate_budget(s, sk.C, (1 << 20) - 20) + 2 > 128
    before = sk.LAUNCHES["sketch_select"]
    H, C = sk.sketch_chunks_fused(x, **kw, s=s)
    Hp, Cp = sk.sketch_chunks_plain(x, **kw, s=s)
    assert sk.LAUNCHES["sketch_select"] == before + 1
    assert torch.equal(H, Hp) and torch.equal(C, Cp)


def _sketches(rng, n, s, universe, bits=64):
    H = np.full((n, s), EMPTY)
    N = np.zeros(n, np.int32)
    for i in range(n):
        m = int(rng.integers(max(1, s // 2), s + 1))
        vals = rng.choice(universe, size=m, replace=False).astype(np.uint64)
        if bits == 64:
            vals = vals * np.uint64(0x9E3779B97F4A7C15)
        else:
            vals = (vals * np.uint64(2654435761)) % np.uint64(2**32 - 1)
        H[i, :m] = np.sort(vals)
        N[i] = m
    return H, N


def _t(a, dev):
    return torch.from_numpy(
        a.view(np.int64) if a.dtype == np.uint64 else a).to(dev)


@pytest.mark.parametrize(
    "nq,nr,s,cap",
    [(5, 9, 40, 40), (33, 70, 17, 10), (100, 37, 1000, 900),
     (64, 64, 1000, 1000), (3, 5, 30000, 30000)],
    ids=["small", "cap_below_s", "uneven", "square", "wider_than_smem"],
)
def test_pairwise_matches_plain(gpu, nq, nr, s, cap):
    rng = np.random.default_rng(nq * 100 + nr)
    qh, qn = _sketches(rng, nq, s, 3 * s)
    rh, rn = _sketches(rng, nr, s, 3 * s)
    Q, NQ, R, NR = (_t(a, gpu) for a in (qh, qn, rh, rn))
    want = td.pairwise_common_denom(Q, NQ, R, NR, cap=cap)
    got64 = pk.pairwise64(Q, NQ, R, NR, cap=cap)
    kq, kr = td.rank_compress(Q, R)
    got32 = pk.pairwise32(kq, NQ, kr, NR, cap=cap)
    torch.cuda.synchronize()
    for got in (got64, got32):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_pairwise32_on_32bit_hashes(gpu):
    rng = np.random.default_rng(1)
    qh, qn = _sketches(rng, 20, 300, 900, bits=32)
    rh, rn = _sketches(rng, 13, 300, 900, bits=32)
    Q, NQ, R, NR = (_t(a, gpu) for a in (qh, qn, rh, rn))
    want = td.pairwise_common_denom(Q, NQ, R, NR, cap=250)
    got = td.pairwise_common_denom_auto(Q, NQ, R, NR, cap=250, use64=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_cli_cuda_matches_cpu(gpu, tmp_path, monkeypatch):
    """``sketch`` and ``dist`` on the card print and write what the CPU's
    plain path does, for a small file and one that takes fast ingest."""
    from mash_tpu_torch.__main__ import main

    files = []
    for i, n in enumerate((30000, 45000, 4_300_000)):
        seq = _seq(i, b"ACGTACGTacgtN", n)
        path = tmp_path / ("g%d.fa" % i)
        path.write_bytes(b">g%d\n" % i + seq.tobytes() + b"\n")
        files.append(str(path))

    def run(device, argv):
        monkeypatch.setenv("MASH_TPU_TORCH_DEVICE", device)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(argv) == 0
        return out.getvalue()

    outs = {}
    before = (sk.LAUNCHES["sketch_select"], pk.LAUNCHES["pairwise64"])
    for device in ("cuda", "cpu"):
        msh = tmp_path / ("all_%s.msh" % device)
        run(device, ["sketch", "-o", str(msh), *files])
        outs[device] = (msh.read_bytes(),
                        run(device, ["dist", str(msh), str(msh)]))
    assert outs["cuda"] == outs["cpu"]
    assert sk.LAUNCHES["sketch_select"] > before[0]
    assert pk.LAUNCHES["pairwise64"] > before[1]
