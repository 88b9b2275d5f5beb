"""The port's 2-process runs (gloo on the CPU) against mash_tpu's single
process.

Spawns two worker processes (``torch_multihost_worker.py``) that run the
port's CLI under the documented ``MASH_TPU_TORCH_COORDINATOR`` launch
environment with ``MASH_TPU_TORCH_DEVICE=cpu``, on the inputs of
``test_multihost_2proc.py`` (k = 21, s = 64, 70 references, 40 queries,
a first record shorter than k in rank 0's file and a comment of more
than 9000 characters in rank 1's), and holds the assembly rules against
``mash_tpu``'s single-process outputs, computed in this process on
JAX-CPU:

- pooled ``sketch -r`` over the sharded files writes the same ``.msh``
  bytes, with the elected globally-first record's comment;
- streamed ``dist``/``triangle`` stripes partition by owner (round-robin
  blocks of the port's CPU ``row_block``, 32) and concatenate to
  ``mash_tpu``'s output; rank 0 alone prints the headers and the Max
  p-value line;
- ``screen``/``taxscreen`` counts sum across ranks, and ``within`` and
  ``find`` run on rank 0: rank 0 prints ``mash_tpu``'s output, rank 1
  nothing.

Every output is text or bytes, so the tolerance is equality.  Skips only
when the coordinator's port cannot be bound; ``MASH_TPU_TORCH_REQUIRE_2PROC=1``
turns that skip into a failure.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

import mash_tpu.commands.dist as jax_dist
import mash_tpu.commands.triangle as jax_tri
from mash_tpu.__main__ import main as jax_main
from mash_tpu.core.params import default_nucleotide_params
from mash_tpu.core.sketch import SketchRef
from mash_tpu.io import capnp_msh

REPO = str(pathlib.Path(__file__).resolve().parent.parent)
WORKER = str(pathlib.Path(__file__).resolve().parent
             / "torch_multihost_worker.py")

K = 21
S = 64
N_REFS = 70  # 3 row stripes of 32
N_QRY = 40  # 2 row stripes
ROW_BLOCK = 32  # the port's stream_pair_stripes row_block on the CPU
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _skip_or_fail(reason: str) -> None:
    if os.environ.get("MASH_TPU_TORCH_REQUIRE_2PROC") == "1":
        raise AssertionError("2-process run unavailable (strict mode): "
                             + reason)
    pytest.skip(reason)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _mk_reads(path, seed, n_reads=120, rl=100, first_short=False,
              first_long_comment=False):
    rng = np.random.default_rng(seed)
    tag = pathlib.Path(path).stem.encode()
    with open(path, "wb") as f:
        if first_short:
            # shorter than k: this file's first valid record is ordinal 1
            f.write(b"@%s_short too_short\nACGT\n+\nIIII\n" % tag)
        for i in range(n_reads):
            seq = rng.choice(ACGT, size=rl).tobytes()
            comment = b"c%d" % i
            if first_long_comment and i == 0:
                # > 8 KiB: the elected header must cross ranks whole
                comment += b" " + b"x" * 9000
            f.write(b"@%s_r%d %s\n%s\n+\n%s\n"
                    % (tag, i, comment, seq, b"I" * rl))


def _mk_msh(path, n, seed):
    rng = np.random.default_rng(seed)
    params = default_nucleotide_params()
    params.kmer_size = K
    params.min_hashes_per_window = S
    pool = np.sort(rng.integers(0, 2**62, size=8 * S, dtype=np.int64)
                   .astype(np.uint64))
    refs = [SketchRef(name="g%03d" % i, comment="c%d" % i,
                      length=int(rng.integers(10**5, 10**6)),
                      hashes=np.sort(np.unique(
                          rng.choice(pool, size=S, replace=False))),
                      counts=None)
            for i in range(n)]
    capnp_msh.write_msh(path, params, refs)


def _mk_find_inputs(root):
    """A 20 kb genome and three queries: two fragments (one reverse
    complemented) and a random sequence."""
    rng = np.random.default_rng(11)
    genome = ACGT[rng.integers(0, 4, 20000)].tobytes()
    ref = root / "genome.fna"
    ref.write_bytes(b">chr1 genome\n" + genome + b"\n")
    rc = genome[12000:14000][::-1].translate(bytes.maketrans(b"ACGT",
                                                             b"TGCA"))
    qry = root / "frags.fna"
    qry.write_bytes(b">fwd\n" + genome[3000:5000] + b"\n>rev\n" + rc
                    + b"\n>rand\n" + ACGT[rng.integers(0, 4, 2000)]
                    .tobytes() + b"\n")
    return str(ref), str(qry)


def _run_jax(args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = jax_main(args)
    assert rc in (0, None), (args, rc, err.getvalue())
    return out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def tw(tmp_path_factory):
    """Inputs, the port's 2-rank run, and mash_tpu's single-process
    outputs."""
    root = tmp_path_factory.mktemp("torch_mh2")
    reads = []
    for i in range(4):
        p = str(root / ("f%d.fastq" % i))
        _mk_reads(p, seed=50 + i, first_short=(i == 0),
                  first_long_comment=(i == 1))
        reads.append(p)
    refs_msh = str(root / "refs.msh")
    qry_msh = str(root / "qry.msh")
    _mk_msh(refs_msh, N_REFS, seed=7)
    _mk_msh(qry_msh, N_QRY, seed=8)
    db_msh = str(root / "db.msh")
    _run_jax(["sketch", "-k", str(K), "-s", str(S), "-o", db_msh] + reads)
    tax_dir = root / "tax"
    tax_dir.mkdir()
    (tax_dir / "nodes.dmp").write_text(
        "1\t|\t1\t|\tno rank\t|\n562\t|\t1\t|\tspecies\t|\n")
    (tax_dir / "names.dmp").write_text(
        "1\t|\troot\t|\t\t|\tscientific name\t|\n"
        "562\t|\tEscherichia coli\t|\t\t|\tscientific name\t|\n")
    tax_db = str(root / "taxdb.msh")
    _run_jax(["sketch", "-k", str(K), "-s", str(S), "-r", "-I", "pool",
              "-C", "taxid 562", "-o", tax_db] + reads)
    find_ref, find_qry = _mk_find_inputs(root)

    outdir = root / "out"
    outdir.mkdir()
    cfg = dict(repo=REPO, outdir=str(outdir), read_files=reads,
               refs_msh=refs_msh, qry_msh=qry_msh, screen_db=db_msh,
               tax_dir=str(tax_dir), tax_db=tax_db, find_ref=find_ref,
               find_qry=find_qry)
    cfg_path = str(root / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)

    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env.update(
            MASH_TPU_TORCH_COORDINATOR="127.0.0.1:%d" % port,
            MASH_TPU_TORCH_NUM_PROCESSES="2",
            MASH_TPU_TORCH_PROCESS_ID=str(rank),
            MASH_TPU_TORCH_DEVICE="cpu",
            OMP_NUM_THREADS="2",
        )
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, cfg_path], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))

    # mash_tpu's single-process outputs, with the same streamed-path
    # forcing, while the workers run
    old = jax_dist.STREAM_MIN_CELLS, jax_tri.STREAM_MIN_SKETCHES
    jax_dist.STREAM_MIN_CELLS = 0
    jax_tri.STREAM_MIN_SKETCHES = 0
    try:
        single = {
            "dist": _run_jax(["dist", refs_msh, qry_msh]),
            "dist_t": _run_jax(["dist", "-t", refs_msh, qry_msh]),
            "triangle": _run_jax(["triangle", refs_msh]),
            "triangle_edge": _run_jax(["triangle", "-E", refs_msh]),
            "screen": _run_jax(["screen", db_msh] + reads),
            "within": _run_jax(["within", "-e", "1", refs_msh, qry_msh]),
            "taxscreen": _run_jax(["taxscreen", "-t", str(tax_dir), tax_db]
                                  + reads),
            "find": _run_jax(["find", "-L", "1000", find_ref, find_qry]),
        }
    finally:
        jax_dist.STREAM_MIN_CELLS, jax_tri.STREAM_MIN_SKETCHES = old
    exp_msh = str(root / "expected.msh")
    _run_jax(["sketch", "-r", "-I", "pooled", "-o", exp_msh] + reads)

    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, (_so, se)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            if "Address already in use" in se or "EADDRINUSE" in se:
                _skip_or_fail("coordinator port unavailable: %s" % se[-500:])
            raise AssertionError("worker %d failed rc=%d\n%s"
                                 % (rank, p.returncode, se))
    for rank in range(2):
        assert (outdir / ("rank%d.done" % rank)).exists()
    return {"outdir": outdir, "single": single, "exp_msh": exp_msh}


def _rank_out(tw, rank, scenario):
    return (tw["outdir"] / ("rank%d_%s.out" % (rank, scenario))).read_text()


def _rank_err(tw, rank, scenario):
    return (tw["outdir"] / ("rank%d_%s.err" % (rank, scenario))).read_text()


@pytest.mark.parametrize("route", ["pooled", "pooled_ingest"],
                         ids=["records", "ingest"])
def test_pooled_sketch_matches_mash_tpu(tw, route):
    """Both reads-mode routes of a rank (the record parser; the native
    ingest, gate lifted) give mash_tpu's single-process bytes."""
    got = (tw["outdir"] / (route + ".msh")).read_bytes()
    assert got == pathlib.Path(tw["exp_msh"]).read_bytes()


def test_pooled_sketch_elected_comment(tw):
    """The comment comes from the globally-first valid record, f1's
    record 0 on rank 1's shard (f0's record 0 is shorter than k), and
    crossed ranks whole."""
    from mash_tpu_torch.io import capnp_msh as torch_msh

    ref = torch_msh.read_msh(str(tw["outdir"] / "pooled.msh")).references[0]
    assert "f1_r0 c0" in ref.comment, ref.comment[:120]
    assert len(ref.comment) > 9000
    assert ("x" * 9000) in ref.comment


def test_dist_stripes_partition_and_concatenate(tw):
    single = tw["single"]["dist"][0].splitlines()
    assert len(single) == N_QRY * N_REFS
    r0 = _rank_out(tw, 0, "dist").splitlines()
    r1 = _rank_out(tw, 1, "dist").splitlines()
    # stripe 0 (query rows 0-31) -> rank 0; stripe 1 (32-39) -> rank 1
    assert r0 == single[: ROW_BLOCK * N_REFS]
    assert r1 == single[ROW_BLOCK * N_REFS :]


def test_dist_table_header_once(tw):
    r0 = _rank_out(tw, 0, "dist_t")
    r1 = _rank_out(tw, 1, "dist_t")
    assert r0.startswith("#query\t")
    assert not r1.startswith("#query")
    assert r0 + r1 == tw["single"]["dist_t"][0]


def test_triangle_header_rows_and_max_pvalue(tw):
    single = tw["single"]["triangle"][0].splitlines()
    r0 = _rank_out(tw, 0, "triangle").splitlines()
    r1 = _rank_out(tw, 1, "triangle").splitlines()
    assert r0[:2] == single[:2]  # the header block, rank 0 only
    body = single[2:]  # rows 1..N-1
    # rank 0 owns row blocks 0 and 2 (rows 1-31 and 64-69), rank 1 block 1
    assert r0[2:] == body[: ROW_BLOCK - 1] + body[2 * ROW_BLOCK - 1 :]
    assert r1 == body[ROW_BLOCK - 1 : 2 * ROW_BLOCK - 1]
    want = [ln for ln in tw["single"]["triangle"][1].splitlines()
            if "Max p-value" in ln]
    assert want and want[0] in _rank_err(tw, 0, "triangle")
    assert "Max p-value" not in _rank_err(tw, 1, "triangle")


def test_triangle_edges_partition_and_concatenate(tw):
    single = tw["single"]["triangle_edge"][0]
    r0 = _rank_out(tw, 0, "triangle_edge")
    r1 = _rank_out(tw, 1, "triangle_edge")
    first = {ln.split("\t")[0] for ln in r1.splitlines()}
    names = ["g%03d" % i for i in range(ROW_BLOCK, 2 * ROW_BLOCK)]
    assert first <= set(names)  # rank 1 prints row block 1 only
    # in stripe order: rank 0's block 0, rank 1's block 1, rank 0's block 2
    cut = r0.find("g%03d\t" % (2 * ROW_BLOCK))
    assert r0[:cut] + r1 + r0[cut:] == single


@pytest.mark.parametrize("scenario", ["screen", "taxscreen", "within",
                                      "find"])
def test_rank0_writes_mash_tpu_output(tw, scenario):
    """Counts summed across ranks (screen, taxscreen) or the whole run on
    rank 0 (within, find): rank 0 prints the single-process output,
    rank 1 nothing."""
    r0 = _rank_out(tw, 0, scenario)
    assert r0 == tw["single"][scenario][0]
    assert len(r0.splitlines()) > 0
    assert _rank_out(tw, 1, scenario) == ""
