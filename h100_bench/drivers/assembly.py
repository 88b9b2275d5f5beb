"""The sketch path of mash_tpu_torch on one whole assembly, one file.

The sketch path's own driver (:mod:`h100_bench.drivers.sketch`) with a
pool of one genome: set-up parses the assembly's FASTA text once with
the program's ``IngestPipeline`` into host batches (about 93 full ones
of 32 rows for GRCh38; the text is freed when the parse returns) and
sketches the file once to warm up.  The window then does what
``core/loader.py::_sketch_file_fast`` does for a file once it is
parsed, again and again on the same batches:
``SketchEngine.fold_batches(..., packed=True)`` on a fresh state, which
carries one state through every upload, merge and certificate settled a
batch behind, then ``SketchEngine.state_to_ref``.  The module has a name
of its own so that the harness finds the assembly's blocked reference
(``reference/assembly.py``) and faults (``faults/assembly.py``).
"""

from h100_bench.drivers.sketch import (  # noqa: F401  (the path's API)
    Setup,
    collect,
    params_of,
    release,
    setup,
    sketch,
    window,
)
