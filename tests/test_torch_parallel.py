"""The port's mesh sharding (``mash_tpu_torch.parallel.mesh``) against its
single-device route and against mash_tpu's mesh.

The counterpart of ``test_parallel.py`` and ``test_mesh_screen.py``.  The
port's ``sharded_sketch_chunks``, ``sharded_pairwise`` and
``sharded_screen_counts`` run over ``[cpu] * 4`` (the device list may
repeat a device) on numpy-seeded inputs, and must equal the port's
single-device route and ``mash_tpu.parallel.mesh``'s function on this
suite's 8-device JAX-CPU mesh (rows a multiple of 8).  The engine, the
host-tiled pairs and the screen fold take the same routes when their
device spans four.  The sharded screen counter's overflow rule follows
``H // n_dev > BIG_DB_MIN``.  Every output is an integer, so the
tolerance is exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mash_tpu.core.params import default_nucleotide_params as jax_params
from mash_tpu.parallel import mesh as jmesh
from mash_tpu_torch.convert import params_from_numpy, state_to_numpy
from mash_tpu_torch.core.engine import SketchEngine
from mash_tpu_torch.ops import distance, screen_ops, sketch_ops
from mash_tpu_torch.ops.kmers import hash_chunk, hash_kw
from mash_tpu_torch.ops.sketch_kernel import sketch_chunks_plain
from mash_tpu_torch.parallel import mesh

CPU4 = [torch.device("cpu")] * 4
EMPTY_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)
UMAX = 2**32 - 1


def _jax_mesh():
    if jax.device_count() < 8:
        pytest.skip("needs conftest's 8-device JAX-CPU mesh")
    return jmesh.default_mesh()


def _chunks(rng, b, n):
    return rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=(b, n))


def test_default_and_local_mesh():
    assert mesh.default_mesh(device="cpu") == [torch.device("cpu")]
    assert mesh.local_mesh(torch.device("cpu")) == [torch.device("cpu")]
    # an index pins one card: no sharding
    assert mesh.local_mesh(torch.device("cuda", 1)) == [torch.device("cuda", 1)]


@pytest.mark.parametrize("k", [15, 21])
def test_sharded_sketch_matches_single_and_mash_tpu(k):
    rng = np.random.default_rng(k)
    jp = jax_params(kmer_size=k, sketch_size=64)
    params = params_from_numpy(jp)
    chunks = _chunks(rng, 8, 4096)
    got = mesh.sharded_sketch_chunks(CPU4, params, torch.from_numpy(chunks),
                                     64)
    sh, sc = sketch_chunks_plain(torch.from_numpy(chunks),
                                 **hash_kw(params), s=64)
    single = sketch_ops.tree_merge(sh, sc, s=64)
    want = jmesh.sharded_sketch_chunks(_jax_mesh(), jp, jnp.asarray(chunks),
                                       64)
    gh, gc = state_to_numpy(got)
    for h, c in (state_to_numpy(single),
                 (np.asarray(want[0]), np.asarray(want[1]))):
        np.testing.assert_array_equal(gh, h)
        np.testing.assert_array_equal(gc, np.asarray(c, np.int64))


def test_sharded_sketch_packed_rows_and_engine_route(tmp_path):
    """Packed ingest rows are unpacked on each device, and an engine that
    spans four devices folds through the sharded route to the same
    state; a row count that does not divide by four takes the
    single-device route."""
    from mash_tpu_torch.io.ingest import IngestPipeline, ingest_available

    rng = np.random.default_rng(3)
    params = params_from_numpy(jax_params(kmer_size=21, sketch_size=64))
    single = SketchEngine(params, chunk_len=4096, device="cpu")
    sharded = SketchEngine(params, chunk_len=4096, device="cpu")
    sharded.devices = CPU4
    for rows in (8, 5):
        batch = torch.from_numpy(_chunks(rng, rows, 4096))
        want = single._fold_rows(single.empty_state(), batch)
        got = sharded._fold_rows(sharded.empty_state(), batch)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    if not ingest_available():
        pytest.skip("native ingest library unavailable")
    seq = _chunks(rng, 1, 40000)[0].tobytes()
    path = str(tmp_path / "packed.fa")
    with open(path, "wb") as f:
        f.write(b">r\n" + seq + b"\n")
    states = []
    for eng in (single, sharded):
        pipe = IngestPipeline([path], 21, 4096, 8, pack_mode=1)
        try:
            states.append(eng.fold_batches(eng.empty_state(), pipe.batches(),
                                           packed=True))
        finally:
            pipe.close()
    for a, b in zip(*states):
        assert torch.equal(a, b)
    assert int((states[0][1] > 0).sum()) == 64


def _sketch_rows(rng, n, s):
    return [np.sort(rng.choice(10000, size=rng.integers(10, s),
                               replace=False)).astype(np.uint64)
            for _ in range(n)]


@pytest.mark.parametrize("use64", [True, False])
def test_sharded_pairwise_matches_single_and_mash_tpu(use64):
    rng = np.random.default_rng(1)
    s = 32
    H, N = distance.pad_sketches(_sketch_rows(rng, 24, s), s)
    Ht = torch.from_numpy(H.view(np.int64))
    Nt = torch.from_numpy(N)
    c1, d1 = mesh.sharded_pairwise(CPU4, Ht, Nt, Ht, Nt, cap=s, use64=use64)
    c2, d2 = distance.pairwise_common_denom(Ht, Nt, Ht, Nt, cap=s)
    c3, d3 = jmesh.sharded_pairwise(_jax_mesh(), jnp.asarray(H),
                                    jnp.asarray(N), jnp.asarray(H),
                                    jnp.asarray(N), cap=s, use64=use64)
    for c, d in ((c2.numpy(), d2.numpy()), (np.asarray(c3), np.asarray(d3))):
        np.testing.assert_array_equal(c1.numpy(), c)
        np.testing.assert_array_equal(d1.numpy(), d)


def test_common_denom_tiled_sharded_route(monkeypatch):
    """With four devices the host tiles pad ``tile_q`` to a multiple of
    four and split its rows; the matrices equal the one-device ones."""
    rng = np.random.default_rng(2)
    s = 32
    H, N = distance.pad_sketches(_sketch_rows(rng, 37, s), s)
    want = distance.common_denom_tiled(H, N, H[:29], N[:29], s, "cpu",
                                       tile_q=10, tile_r=8)
    monkeypatch.setattr(mesh, "local_mesh", lambda dev: CPU4)
    got = distance.common_denom_tiled(H, N, H[:29], N[:29], s, "cpu",
                                      tile_q=10, tile_r=8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _screen_inputs(seed):
    """Two 20 000-base chunks and a DB of 150 of the first chunk's
    hashes and 200 random ones."""
    rng = np.random.default_rng(seed)
    jp = jax_params()
    params = params_from_numpy(jp)
    chunks = [rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=20000)
              for _ in range(2)]
    h, v = hash_chunk(torch.from_numpy(chunks[0]), **hash_kw(params))
    present = np.unique(h[v].numpy().view(np.uint64))[:150]
    absent = rng.integers(0, 2**63, size=200, dtype=np.int64).astype(np.uint64)
    return jp, params, chunks, np.unique(np.concatenate([present, absent]))


@pytest.mark.parametrize("seed", [7, 8])
def test_sharded_screen_counts_match_single_and_mash_tpu(seed):
    jp, params, chunks, db = _screen_inputs(seed)
    s = 64
    counts, state = mesh.sharded_screen_counts(
        CPU4, params, db, [torch.from_numpy(c) for c in chunks], s)

    fold, _rows, c0, finalize = screen_ops.make_screen_fold(params, db, s,
                                                            "cpu")
    st = sketch_ops.empty_state(s)
    for c in chunks:
        c0, st = fold(c0, st, torch.from_numpy(c))
    np.testing.assert_array_equal(counts, finalize(c0))
    for a, b in zip(state, st):
        assert torch.equal(a, b)
    assert (counts > 0).sum() >= 150  # every hash taken from the chunk

    pad = (-len(db)) % 8
    dbp = np.concatenate([db, np.full(pad, EMPTY_U64)])
    jc, jstate = jmesh.sharded_screen_counts(
        _jax_mesh(), jp, jnp.asarray(dbp), [jnp.asarray(c) for c in chunks], s)
    np.testing.assert_array_equal(counts, np.asarray(jc)[: len(db)])
    gh, gc = state_to_numpy(state)
    np.testing.assert_array_equal(gh, np.asarray(jstate[0]))
    np.testing.assert_array_equal(gc, np.asarray(jstate[1], np.int64))


def test_screen_fold_sharded_route(monkeypatch):
    """A screen fold whose device spans four range-shards the DB (one
    counter a device, the last range shorter) and gives the one-device
    counts and state."""
    _jp, params, chunks, db = _screen_inputs(9)
    rows = torch.from_numpy(np.stack(chunks))
    out = []
    for devices in (None, CPU4):
        if devices is not None:
            monkeypatch.setattr(mesh, "local_mesh", lambda dev: devices)
        _f, fold_rows, c0, finalize = screen_ops.make_screen_fold(
            params, db, 64, "cpu")
        c0, st = fold_rows(c0, sketch_ops.empty_state(64), rows)
        out.append((finalize(c0), st))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("per_device", [screen_ops.BIG_DB_MIN,
                                        screen_ops.BIG_DB_MIN + 1],
                         ids=["at_big_db_min", "above"])
def test_sharded_counter_overflow_rule(per_device):
    """Counts saturate at 2^31-1 only when each device's range holds more
    than BIG_DB_MIN hashes (mash_tpu's mesh big-DB tier); at BIG_DB_MIN
    they wrap at 2^32."""
    H = 4 * per_device
    db = np.arange(1, H + 1, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    db = np.sort(db)
    counter = mesh.ShardedScreenCounter(CPU4, db)
    big = per_device > screen_ops.BIG_DB_MIN
    assert counter.big_db == big
    assert [c.H for c in counter.counters] == [per_device] * 4
    seeded = [2**32 + 5, 2**31, 2**31 - 1, 3]
    for i, c in enumerate(counter.counters):
        c.totals[-1] = seeded[i]
    got = counter.finalize()[per_device - 1 :: per_device]
    want = ([2**31 - 1, 2**31 - 1, 2**31 - 1, 3] if big
            else [5, 2**31, 2**31 - 1, 3])
    np.testing.assert_array_equal(got, want)
