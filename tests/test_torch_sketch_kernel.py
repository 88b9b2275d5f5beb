"""mash_tpu_torch.ops.sketch_kernel on the CPU against the Pallas kernel.

On a CPU tensor ``sketch_select`` runs its plain version, so these cases
cover everything around the CUDA kernel (subrow layout, candidate fold,
certificate, fallback) against ``mash_tpu.ops.pallas_sketch`` in
interpret mode, mirroring ``tests/test_pallas_sketch.py``.  The kernel
itself is held against the plain version on the GPU by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mash_tpu.core.params import default_nucleotide_params
from mash_tpu.ops import pallas_sketch as ps
from mash_tpu.ops.kmers import alphabet_bytes
from mash_tpu_torch.ops import sketch_kernel as sk
from mash_tpu_torch.ops.sketch_ops import candidate_budget

ALPHA = alphabet_bytes(default_nucleotide_params().alphabet)


def _check(chunks, k, s, use64, noncanon):
    kw = dict(alphabet=ALPHA, k=k, seed=42, use64=use64,
              noncanonical=noncanon, preserve_case=False)
    ref = ps.sketch_chunks_pallas(jnp.asarray(chunks), **kw, s=s)
    x = torch.from_numpy(np.ascontiguousarray(chunks))
    for fn in (sk.sketch_chunks_fused, sk.sketch_chunks_plain):
        H, C = fn(x, **kw, s=s)
        np.testing.assert_array_equal(np.asarray(ref[0]),
                                      H.numpy().view(np.uint64))
        np.testing.assert_array_equal(np.asarray(ref[1]), C.numpy())


@pytest.fixture(scope="module")
def dna():
    rng = np.random.default_rng(5)
    return rng.choice(
        np.frombuffer(b"ACGTacgtNN" + bytes([0]), dtype=np.uint8),
        size=(2, 40000),
    )


def test_fused_basic(dna):
    _check(dna, 21, 50, True, False)


def test_fused_noncanonical(dna):
    _check(dna, 21, 50, True, True)


def test_fused_32bit(dna):
    _check(dna, 15, 50, False, False)


@pytest.mark.parametrize("k,use64", [(32, True), (9, False)])
def test_fused_k_edges(dna, k, use64):
    _check(dna, k, 50, use64, False)


def test_fused_fallbacks(dna):
    rep = np.tile(np.frombuffer(b"AT", dtype=np.uint8), 20000)[
        None, :
    ].repeat(2, 0)
    _check(rep, 21, 50, True, False)  # repetitive -> verified fallback
    mix = dna.copy()
    mix[1] = rep[0]
    _check(mix, 21, 50, True, False)
    _check(np.zeros((2, 40000), np.uint8), 21, 50, True, False)


def test_fused_large_budget(dna, monkeypatch):
    """A budget above the TPU kernel's 3m + 2 <= 128 output limit still
    goes through ``sketch_select`` (the CUDA kernel keeps up to C - 1)."""
    s = 2000
    m = candidate_budget(s, sk.C, 40000 - 20)
    assert 3 * m + 2 > 128 and m < sk.C
    budgets = []
    select = sk.sketch_select

    def spy(chunks, **kw):
        budgets.append(kw["m"])
        return select(chunks, **kw)

    monkeypatch.setattr(sk, "sketch_select", spy)
    _check(dna, 21, s, True, False)
    assert budgets == [m]


def test_select_layout(dna):
    """Candidates are each subrow's m smallest hashes in unsigned order,
    the boundary the next one, and vcount the valid windows."""
    k, m = 21, candidate_budget(50, sk.C, 40000 - 20)
    x = torch.from_numpy(dna)
    cand, boundary, vcount = sk.sketch_select(
        x, alphabet=ALPHA, k=k, seed=42, use64=True, noncanonical=False,
        preserve_case=False, m=m)
    R = (40000 - k + 1 + sk.C - 1) // sk.C
    assert cand.shape == (2 * R, m) and boundary.shape == (2 * R,)
    u = cand.numpy().view(np.uint64)
    assert (np.diff(u, axis=1) >= 0).all()
    assert (u[:, -1] <= boundary.numpy().view(np.uint64)).all()
    from mash_tpu_torch.ops.kmers import hash_chunk

    _, v = hash_chunk(x, alphabet=ALPHA, k=k, seed=42, use64=True,
                      noncanonical=False, preserve_case=False)
    assert int(vcount.sum()) == int(v.sum())


def test_select_rejects_bad_input(dna):
    kw = dict(alphabet=ALPHA, k=21, seed=42, use64=True, noncanonical=False,
              preserve_case=False)
    with pytest.raises(ValueError):
        sk.sketch_select(torch.from_numpy(dna).long(), **kw, m=16)
    with pytest.raises(ValueError):
        sk.sketch_select(torch.from_numpy(dna), **kw, m=sk.C)
