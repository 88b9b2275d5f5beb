"""Worker process for the port's 2-process test.

Launched (one per rank) by ``test_torch_multihost_2proc.py`` with the
``MASH_TPU_TORCH_COORDINATOR`` / ``MASH_TPU_TORCH_NUM_PROCESSES`` /
``MASH_TPU_TORCH_PROCESS_ID`` environment the CLI's multi-process launch
documents, and ``MASH_TPU_TORCH_DEVICE`` (``cpu``, or ``cuda`` in the GPU
tests).  Runs the CLI scenarios (those named in the config's ``only``,
if given) through ``mash_tpu_torch.__main__.main`` (which joins the gloo
group) and writes each rank's stdout and stderr per scenario, so the
parent can assert the cross-process assembly rules.

Usage: python torch_multihost_worker.py <config.json>
"""

import contextlib
import io
import json
import os
import sys

CFG = json.load(open(sys.argv[1]))
RANK = int(os.environ["MASH_TPU_TORCH_PROCESS_ID"])
sys.path.insert(0, CFG["repo"])

import mash_tpu_torch.commands.dist as dist_mod  # noqa: E402
import mash_tpu_torch.commands.triangle as tri_mod  # noqa: E402
import mash_tpu_torch.io.ingest as ingest  # noqa: E402
from mash_tpu_torch.__main__ import main  # noqa: E402
from mash_tpu_torch.parallel import multihost as mh  # noqa: E402

# force the streamed (stripe-owned) paths at test sizes
dist_mod.STREAM_MIN_CELLS = 0
tri_mod.STREAM_MIN_SKETCHES = 0

outdir = CFG["outdir"]
FAST_MIN = ingest.FAST_INGEST_MIN_BYTES


def run(scenario, argv):
    """Run ``argv()`` through the CLI unless the config's ``only`` leaves
    ``scenario`` out; write its stdout and stderr."""
    if "only" in CFG and scenario not in CFG["only"]:
        return
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv())
    if rc not in (0, None):
        raise SystemExit("%s exited %s:\n%s" % (scenario, rc, err.getvalue()))
    base = os.path.join(outdir, "rank%d_%s" % (RANK, scenario))
    with open(base + ".out", "w") as f:
        f.write(out.getvalue())
    with open(base + ".err", "w") as f:
        f.write(err.getvalue())


assert mh.maybe_init_distributed()
assert mh.process_count() == 2 and mh.process_index() == RANK
run("sketch", lambda: ["sketch", "-r", "-I", "pooled", "-o",
                       os.path.join(outdir, "pooled.msh")]
    + CFG["read_files"])
# the same pool through the native ingest route (its 4 MiB gate lifted)
ingest.FAST_INGEST_MIN_BYTES = 0
run("sketch_ingest", lambda: ["sketch", "-r", "-I", "pooled", "-o",
                              os.path.join(outdir, "pooled_ingest.msh")]
    + CFG["read_files"])
ingest.FAST_INGEST_MIN_BYTES = FAST_MIN
run("dist", lambda: ["dist", CFG["refs_msh"], CFG["qry_msh"]])
run("dist_t", lambda: ["dist", "-t", CFG["refs_msh"], CFG["qry_msh"]])
run("triangle", lambda: ["triangle", CFG["refs_msh"]])
run("triangle_edge", lambda: ["triangle", "-E", CFG["refs_msh"]])
run("screen", lambda: ["screen", CFG["screen_db"]] + CFG["read_files"])
run("within", lambda: ["within", "-e", "1", CFG["refs_msh"],
                       CFG["qry_msh"]])
run("taxscreen", lambda: ["taxscreen", "-t", CFG["tax_dir"], CFG["tax_db"]]
    + CFG["read_files"])
run("find", lambda: ["find", "-L", "1000", CFG["find_ref"],
                     CFG["find_qry"]])

with open(os.path.join(outdir, "rank%d.done" % RANK), "w") as f:
    f.write("ok")
