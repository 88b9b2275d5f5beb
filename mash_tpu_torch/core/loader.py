"""Building SketchSets from mixed inputs (.msh files or sequence files).

The counterpart of ``mash_tpu.core.loader`` (``Sketch::initFromFiles`` /
``initFromReads``, ``src/mash/Sketch.cpp:96-253``): ``.msh`` inputs are
parameter-checked, adopted (first file, unless parameters are enforced)
and loaded with truncation; sequence files are sketched per file
(concatenated), per record (individual mode, ``-i``) or pooled over all
files (reads mode) through the device engine; under a multi-process
launch reads mode shards the files over the processes and merges their
states (``parallel.multihost``).  Windowed mode (``-W``) stores each
record's minmer (position, hash) loci.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np

from mash_tpu_torch.core.engine import (
    SketchEngine,
    sketch_records_concat,
    sketch_records_exact,
    sketch_records_individual,
)
from mash_tpu_torch.core.params import SketchParams
from mash_tpu_torch.core.sketch import SketchRef, SketchSet, check_compatibility
from mash_tpu_torch.io import capnp_msh
from mash_tpu_torch.io.fastx import read_fastx, read_fastx_multi
from mash_tpu_torch.io.formatting import cpp_double
from mash_tpu_torch.io.ingest import IngestPipeline, fast_ingest_eligible
from mash_tpu_torch.parallel import multihost as mh

SUFFIX_SKETCH = ".msh"
SUFFIX_SKETCH_WINDOWED = ".msw"


def has_suffix(path: str, suffix: str) -> bool:
    return path.endswith(suffix)


def is_sketch_file(path: str, windowed: bool = False) -> bool:
    return has_suffix(
        path, SUFFIX_SKETCH_WINDOWED if windowed else SUFFIX_SKETCH
    )


def adopt_params_from_msh(params: SketchParams, path: str,
                          data: bytes | None = None) -> int:
    """Adopt header parameters from a sketch file; returns reference count.

    Mirrors ``Sketch::initParametersFromCapnp`` (``Sketch.cpp:255-324``):
    copies k, error, sketch size, window size, flags, seed, counts presence
    and alphabet into ``params``.
    """
    other, n = capnp_msh.read_msh_header(path, data=data)
    params.kmer_size = other.kmer_size
    params.error = other.error
    params.min_hashes_per_window = other.min_hashes_per_window
    params.window_size = other.window_size
    params.concatenated = other.concatenated
    params.noncanonical = other.noncanonical
    params.preserve_case = other.preserve_case
    params.counts = other.counts
    params.seed = other.seed
    params.set_alphabet(other.alphabet_string())
    return n


def needs_exact_streaming(params: SketchParams) -> bool:
    """Whether sketching must use the exact stream-order path.

    The batch bottom-s fold produces identical hash SETS for the default
    settings, but ``-m``/``-b``/``-c`` gating and stored multiplicities
    (``-M``) depend on stream order (``MinHashHeap.cpp:68-146``), so those
    modes run the device-hash + native-heap hybrid.
    """
    return (
        params.reads
        and (
            params.min_cov > 1
            or params.memory_bound > 0
            or params.target_cov > 0
        )
    ) or params.counts


def _sketch_concat(engine, records, file_name, is_stdin):
    if needs_exact_streaming(engine.params):
        return sketch_records_exact(engine, records, file_name, is_stdin)
    return sketch_records_concat(engine, records, file_name, is_stdin)


def _fast_batch_rows(device) -> int:
    return 32 if device.type == "cuda" else 8


def _fast_ingest_ok(params: SketchParams, paths) -> bool:
    """Fast path preconditions: order-free fold + native parser + real
    files.  The exact modes need records in stream order."""
    if needs_exact_streaming(params) or params.windowed:
        return False
    return fast_ingest_eligible(paths)


def _sketch_paths_fast(engine: SketchEngine, paths: List[str]):
    """Sketch one or more files into one state via the ingest pipeline.

    For the plain nucleotide alphabet the host packs rows to 2-bit codes
    + validity bitmask (2.67x smaller transfers); other alphabets ship
    raw bytes.  Returns (state, metas).
    """
    p = engine.params
    pack = 0
    if p.alphabet_string() == "ACGT":
        pack = 2 if p.preserve_case else 1
    rows = _fast_batch_rows(engine.device)
    pipe = IngestPipeline(
        paths, p.kmer_size, engine.chunk_len, rows, pack_mode=pack
    )
    try:
        state = engine.fold_batches(
            engine.empty_state(), pipe.batches(), packed=bool(pack)
        )
    finally:
        pipe.close()
    return state, pipe.metas


def _sketch_file_fast(engine: SketchEngine, path: str):
    """Fast-path equivalent of ``sketch_records_concat`` for one file."""
    state, metas = _sketch_paths_fast(engine, [path])
    meta = metas[0]
    p = engine.params
    name, comment = meta.name_comment(is_stdin=False)
    if meta.count == 0:
        name, comment = path, ""
    total_len = meta.total_len
    if p.reads:
        if p.genome_size != 0:
            total_len = p.genome_size
        else:
            total_len = int(engine.estimate_set_size(state))
    if meta.count > 1:
        comment = "[%d seqs] %s [...]" % (meta.count, comment)
    ref = engine.state_to_ref(state, name, comment, total_len)
    return ref, state, meta.count, meta.skipped


def _fast_pool_metas(metas):
    """Pooled count/skipped + the first-valid-record candidate.

    ``best`` is ``(first_ordinal, file_index)`` — the record's
    round-robin position key (the reference visits record ``r`` of file
    ``f`` at position ``(r, f)``, ``Sketch.cpp:1200-1270``) — or None
    when no file had a valid record.
    """
    count = sum(m.count for m in metas)
    skipped = any(m.skipped for m in metas)
    best = min(
        (
            (m.first_ordinal, i)
            for i, m in enumerate(metas)
            if m.first_ordinal >= 0
        ),
        default=None,
    )
    return count, skipped, best


def init_from_files(
    files: List[str],
    params: SketchParams,
    verbosity: int = 0,
    enforce_parameters: bool = False,
    contain: bool = False,
    engine: Optional[SketchEngine] = None,
    device=None,
) -> SketchSet:
    """Load/sketch every input into one SketchSet (``Sketch::initFromFiles``).

    Parameter adoption from the first ``.msh`` file mutates only the
    SketchSet's own parameter copy, never the caller's ``params``.
    Sequence files are sketched on ``device`` (default: see
    :func:`mash_tpu_torch.utils.resolve_device`) unless an ``engine`` is
    given.
    """
    params = params.copy()
    sketch_set = SketchSet(params)
    err = sys.stderr

    for i, path in enumerate(files):
        if is_sketch_file(path, params.windowed):
            # one read serves header inspection, parameter adoption and
            # the full load
            with open(path, "rb") as f:
                data = f.read()
            other, _ = capnp_msh.read_msh_header(path, data=data)
            if i == 0 and not enforce_parameters:
                adopt_params_from_msh(params, path, data=data)
            if not check_compatibility(
                params, other, path, enforce_size=not contain
            ):
                continue
            msh = capnp_msh.read_msh(
                path, max_hashes=params.min_hashes_per_window,
                data=data,
            )
            del data
            for j, ref in enumerate(msh.references):
                positions = None
                if j < len(msh.position_hashes):
                    positions = msh.position_hashes[j]
                sketch_set.add(ref, positions)
            continue
        if engine is None:
            engine = SketchEngine(params, device=device)
        if verbosity > 0:
            if path == "-":
                err.write("Sketching from stdin...\n")
            else:
                err.write("Sketching %s...\n" % path)
        if params.concatenated:
            if _fast_ingest_ok(params, [path]):
                ref, _state, count, skipped = _sketch_file_fast(engine, path)
            else:
                ref, _state, count, skipped = _sketch_concat(
                    engine, read_fastx(path), path, is_stdin=(path == "-")
                )
            if ref.length == 0:
                if skipped:
                    err.write(
                        "\nWARNING: All fasta records in %s were "
                        "shorter than the k-mer size (%d).\n"
                        % (path, params.kmer_size)
                    )
                else:
                    err.write(
                        '\nERROR: Did not find fasta records in '
                        '"%s".\n' % path
                    )
                raise SystemExit(1)
            sketch_set.add(ref)
        elif params.windowed:
            _sketch_records_windowed(engine, path, sketch_set)
        elif needs_exact_streaming(params):
            # individual mode with stored multiplicities: one exact heap
            # per record (``sketchFileBySequence`` + ``sketchSequence``)
            _sketch_records_exact_each(engine, path, sketch_set)
        else:
            # individual mode: rows of same-bucket records per launch
            stats: dict = {}
            n_before = len(sketch_set.references)
            for ref in sketch_records_individual(
                engine, read_fastx(path), stats=stats
            ):
                sketch_set.add(ref)
            if len(sketch_set.references) == n_before:
                if stats.get("skipped"):
                    err.write(
                        "\nWARNING: All fasta records in %s "
                        "were shorter than the k-mer size "
                        "(%d).\n" % (path, params.kmer_size)
                    )
                else:
                    err.write("\nERROR: reading %s.\n" % path)
                raise SystemExit(1)
    return sketch_set


def _sketch_records_windowed(engine: SketchEngine, path: str,
                             sketch_set: SketchSet) -> None:
    """One windowed (``-W``) entry per record of ``path``: its minmer
    ``[n, 2]`` (position, hash) loci, or none when it has no minmer."""
    any_record = False
    for rec in read_fastx(path):
        if len(rec.seq) < engine.params.kmer_size:
            continue
        any_record = True
        pos, hh = engine.windowed_positions(rec.seq)
        sketch_set.add(
            SketchRef(name=rec.name, comment=rec.comment or "",
                      length=len(rec.seq)),
            np.stack([pos.astype(np.uint64), hh], axis=1) if len(pos)
            else None,
        )
    if not any_record:
        sys.stderr.write("\nERROR: reading %s.\n" % path)
        raise SystemExit(1)


def _sketch_records_exact_each(engine: SketchEngine, path: str,
                               sketch_set: SketchSet) -> None:
    """One exact-heap sketch per record of ``path`` (``-i -M``)."""
    from mash_tpu_torch.native import ExactHeap

    params = engine.params
    any_record = False
    for rec in read_fastx(path):
        if len(rec.seq) < params.kmer_size:
            continue
        any_record = True
        h, v = engine.hash_bytes(rec.seq)
        heap = ExactHeap(
            params.sketch_size,
            params.min_cov if params.reads else 1,
            params.memory_bound,
            params.use64,
        )
        heap.insert(h[v])
        hh, cc = heap.extract()
        sketch_set.add(
            SketchRef(
                name=rec.name,
                comment=rec.comment or "",
                length=len(rec.seq),
                hashes=hh,
                counts=cc,
                counts_sorted=True,
            )
        )
    if not any_record:
        sys.stderr.write("\nERROR: reading %s.\n" % path)
        raise SystemExit(1)


def _sketch_reads_pooled(engine: SketchEngine, files: List[str],
                         first_name: str):
    """Pooled reads-mode sketch over all files on the order-free routes.

    Each process sketches its round-robin shard of ``files`` (all of them
    in a single process): through the ingest pipeline, one file after
    another, or through the record parser.  The bottom-s fold is
    order-independent, so only the naming needs the reference's record
    round-robin (``Sketch.cpp:1200-1270``): the pool is named after the
    first valid record of the walk over all files, not rank 0's first.
    A record's key is its round-robin position (record ordinal, global
    file index; the shard is ``files[pid::P]``, so local file i is
    global file ``pid + i * P``); the processes elect the smallest key's
    header and merge their states and record counts, so every process
    ends with the same pooled sketch.
    """
    params = engine.params
    P, pid = mh.process_count(), mh.process_index()
    local_files = mh.shard_paths(files)
    is_stdin = first_name == ""
    loc_key = (-1, 0)
    loc_name, loc_comment = "", ""
    if local_files and _fast_ingest_ok(params, local_files):
        state, metas = _sketch_paths_fast(engine, local_files)
        count, skipped, best = _fast_pool_metas(metas)
        if best is not None:
            loc_name, loc_comment = metas[best[1]].name_comment(
                is_stdin=is_stdin)
            loc_key = (best[0], pid + best[1] * P)
    elif local_files:
        seen = {}

        def records():
            for rec, r, fi in read_fastx_multi(local_files, round_robin=True,
                                               with_pos=True):
                if "best" not in seen and len(rec.seq) >= params.kmer_size:
                    seen["best"] = (r, fi, rec)
                yield rec

        _ref, state, count, skipped = _sketch_concat(
            engine, records(), first_name, is_stdin=is_stdin)
        if "best" in seen:
            r, fi, rec = seen["best"]
            if is_stdin:
                loc_name, loc_comment = rec.name, rec.comment or ""
            else:
                loc_comment = rec.name + " " + (rec.comment or "")
            loc_key = (r, pid + fi * P)
    else:
        state = engine.empty_state()
        count, skipped = 0, False
    payload = mh.elect_min_with_payload(
        loc_key[0], loc_key[1],
        loc_name.encode("utf-8") + b"\x00" + loc_comment.encode("utf-8"))
    nm, _, cm = payload.partition(b"\x00")
    g_name = nm.decode("utf-8", "replace")
    comment = cm.decode("utf-8", "replace")
    state = mh.merge_states_across_hosts(state, params.sketch_size)
    count, _tl, skipped = mh.reduce_meta_across_hosts(count, 0, skipped)
    if params.genome_size != 0:
        total_len = params.genome_size
    else:
        total_len = int(engine.estimate_set_size(state))
    if count > 1:
        comment = "[%d seqs] %s [...]" % (count, comment)
    ref = engine.state_to_ref(state, g_name if is_stdin else first_name,
                              comment, total_len)
    return ref, state, count, skipped


def init_from_reads(
    files: List[str],
    params: SketchParams,
    engine: Optional[SketchEngine] = None,
    device=None,
) -> SketchSet:
    """Reads mode: one pooled sketch over all files (``initFromReads``).

    The order-free routes shard the files over the processes of a
    multi-process launch (:func:`_sketch_reads_pooled`); the exact route
    (``needs_exact_streaming``) reads every file round-robin by record,
    in every process, as in ``mash_tpu``.
    """
    if engine is None:
        engine = SketchEngine(params, device=device)
    sketch_set = SketchSet(params)
    first_name = files[0] if files and files[0] != "-" else ""
    if not needs_exact_streaming(params):
        ref, state, count, skipped = _sketch_reads_pooled(
            engine, files, first_name
        )
    else:
        records = read_fastx_multi(files, round_robin=True)
        ref, state, count, skipped = _sketch_concat(
            engine, records, first_name, is_stdin=(first_name == "")
        )
    if ref.length == 0:
        if skipped:
            sys.stderr.write(
                "\nWARNING: All fasta records in input files were shorter "
                "than the k-mer size (%d).\n" % params.kmer_size
            )
        else:
            sys.stderr.write(
                '\nERROR: Did not find fasta records in "input files".\n'
            )
        raise SystemExit(1)
    sketch_set.add(ref)
    if needs_exact_streaming(params):
        set_size = state.set_size()
        mult = state.multiplicity()
    else:
        set_size = engine.estimate_set_size(state)
        mult = engine.estimate_multiplicity(state)
    sys.stderr.write("Estimated genome size: %s\n" % cpp_double(set_size))
    sys.stderr.write("Estimated coverage:    %s\n" % cpp_double(mult))
    if params.target_cov > 0:
        sys.stderr.write("Reads used:            %d\n" % count)
    return sketch_set
