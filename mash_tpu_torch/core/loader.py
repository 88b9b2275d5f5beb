"""Building SketchSets from mixed inputs (.msh files or sequence files).

The counterpart of ``mash_tpu.core.loader`` for whole-file genome
sketching: ``.msh`` inputs are parameter-checked, adopted (first file,
unless parameters are enforced) and loaded with truncation; sequence
files are sketched per file through the device engine
(``Sketch::initFromFiles``, ``src/mash/Sketch.cpp:96-253``).  Reads
mode, individual mode (``-i``), windowed mode (``-W``) and stored
multiplicities (``-M``) raise :class:`mash_tpu_torch.NotPortedError`.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from mash_tpu_torch import NotPortedError
from mash_tpu_torch.core.engine import SketchEngine, sketch_records_concat
from mash_tpu_torch.core.params import SketchParams
from mash_tpu_torch.core.sketch import SketchSet, check_compatibility
from mash_tpu_torch.io import capnp_msh
from mash_tpu_torch.io.fastx import read_fastx
from mash_tpu_torch.io.ingest import IngestPipeline, fast_ingest_eligible

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


def require_ported(params: SketchParams) -> None:
    """Raise NotPortedError for sketching modes outside this package."""
    if params.reads:
        raise NotPortedError("reads mode (-r, -m, -b, -c, -g)")
    if params.windowed:
        raise NotPortedError("windowed sketching (-W)")
    if not params.concatenated:
        raise NotPortedError("individual mode (-i)")
    if params.counts:
        raise NotPortedError("stored multiplicities (-M)")


def _fast_batch_rows(device) -> int:
    return 32 if device.type == "cuda" else 8


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
    name, comment = meta.name_comment(is_stdin=False)
    if meta.count == 0:
        name, comment = path, ""
    if meta.count > 1:
        comment = "[%d seqs] %s [...]" % (meta.count, comment)
    ref = engine.state_to_ref(state, name, comment, meta.total_len)
    return ref, state, meta.count, meta.skipped


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
        require_ported(params)
        if engine is None:
            engine = SketchEngine(params, device=device)
        if verbosity > 0:
            if path == "-":
                err.write("Sketching from stdin...\n")
            else:
                err.write("Sketching %s...\n" % path)
        if fast_ingest_eligible([path]):
            ref, _state, count, skipped = _sketch_file_fast(engine, path)
        else:
            ref, _state, count, skipped = sketch_records_concat(
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
    return sketch_set
