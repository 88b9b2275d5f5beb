"""The traffic generators: the sizes a traffic file asks for, the same
data from the same seed, and for another seed the same sizes (so seeds
change no work) with other bases."""

import json
import os

import numpy as np
import pytest
import torch

from benchtest_util import SEED, tiny

from h100_bench import harness, seqgen

BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def generate(cell, seed):
    _c, config, traffic = harness.cell_parts(BENCH, cell)
    config, traffic = tiny(config, traffic)
    generator, _d, _r = harness.path_modules(traffic)
    return config, traffic, generator.generate(config, traffic, seed,
                                               torch.device("cpu"))


def sizes_and_bytes(data):
    if hasattr(data, "genomes"):
        sizes = sorted(tuple(len(r) for r in g) for g in data.genomes)
        return sizes, b"".join(r.tobytes() for g in data.genomes for r in g)
    sizes = (sorted(len(g) for g in data.present),
             sorted(len(g) for g in data.absent), data.reads.shape,
             data.random_db.shape, len(data.present_slots))
    return sizes, data.reads.tobytes() + data.random_db.tobytes()


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_data_other_seed_same_sizes(cell):
    *_, a = generate(cell, SEED)
    *_, b = generate(cell, SEED)
    *_, c = generate(cell, 3)
    sa, ba = sizes_and_bytes(a)
    sb, bb = sizes_and_bytes(b)
    sc, bc = sizes_and_bytes(c)
    assert sa == sb and ba == bb
    assert sa == sc and ba != bc


@pytest.mark.parametrize("cell", CELLS)
def test_sizes_follow_the_traffic_file(cell):
    config, traffic, data = generate(cell, SEED)
    if traffic["driver"] == "sketch":
        assert len(data.genomes) == traffic["genomes"]
        lo, hi = traffic["records"]
        for g in data.genomes:
            assert lo <= len(g) <= hi
        total = data.lengths()
        assert total.min() >= traffic["genome_mbase"][0] * 1e6 * 0.99
    else:
        assert len(data.present) == traffic["present"]
        assert len(data.absent) == traffic["absent"]
        assert data.reads.shape == (traffic["parts"] * traffic["reads_per_part"],
                                    traffic["read_len"])
        assert data.random_db.shape == (
            config["db_sketches"] - traffic["present"], config["sketch_size"])
        assert (np.diff(data.random_db.astype(np.float64), axis=1) > 0).all()
        slots = data.present_slots
        assert len(set(slots.tolist())) == len(slots) and slots.max() < \
            config["db_sketches"]


def test_contig_layout_follows_its_keys():
    """The pool's ``contigs`` layout (MAGs in many contigs), which no
    cell's mix uses yet."""
    _c, config, traffic = harness.cell_parts(BENCH, "sketch_refseq_genomes")
    traffic = dict(traffic, genomes=4, genome_mbase=[0.15, 0.4],
                   layout="contigs", records=[5, 20], contig_sigma=1.0,
                   min_contig=1000)
    generator, _d, _r = harness.path_modules(traffic)
    a = generator.generate(config, traffic, SEED, torch.device("cpu"))
    b = generator.generate(config, traffic, 3, torch.device("cpu"))
    assert len(a.genomes) == 4
    for g in a.genomes:
        assert 5 <= len(g) <= 20 and min(len(r) for r in g) >= 1000
    assert a.lengths().min() >= 0.15e6 * 0.99
    assert sizes_and_bytes(a)[0] == sizes_and_bytes(b)[0]


def test_full_size_traffic_files():
    """The mixes at their real sizes: a screen part fills one batch of 32
    rows, and the pools are what the cells' reasons say."""
    folder = os.path.join(harness.BENCH_DIR, "traffic")
    for name in sorted(os.listdir(folder)):
        t = json.load(open(os.path.join(folder, name)))
        if t["driver"] != "screen":
            continue
        k = 21
        stream = t["reads_per_part"] * (t["read_len"] + 1) - 1
        rows = -(-(stream - (k - 1)) // (t["chunk_len"] - (k - 1)))
        assert rows <= t["batch_rows"]
        assert t["parts"] * t["reads_per_part"] * t["read_len"] > 250 * 2**20


def test_fasta_and_fastq_text():
    seq = np.frombuffer(b"ACGT" * 45 + b"A", np.uint8)
    text = seqgen.fasta([(b"x y", seq)], width=80)
    lines = text.split(b"\n")
    assert lines[0] == b">x y" and [len(x) for x in lines[1:]] == [80, 80, 21, 0]
    assert b"".join(lines[1:]) == seq.tobytes()
    reads = np.frombuffer(b"ACGTN" * 2, np.uint8).reshape(2, 5)
    assert seqgen.fastq(reads, 7) == (b"@000000007\nACGTN\n+\nIIIII\n"
                                      b"@000000008\nACGTN\n+\nIIIII\n")


def test_shares_sum_to_the_total():
    w = seqgen.lognormal_quantiles(1.0, 64)
    out = seqgen.shares(w, 1_776_000)
    assert out.sum() == 1_776_000 and (out > 0).all()
