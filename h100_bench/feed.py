"""Hand sequence text to the program's ingest, as the CLI reads a file.

The text goes through a named pipe under ``$TMPDIR`` (the driver gives
each run its own), so the program's ``IngestPipeline`` opens and parses a
path as it does any input file, and nothing is written to disk.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading


def ingest(text: bytes, k: int, chunk_len: int, batch_rows: int,
           pack_mode: int = 1) -> list:
    """The batches ``mash_tpu_torch.io.ingest.IngestPipeline`` makes of
    ``text`` (``[batch_rows, row bytes]`` uint8, packed with
    ``pack_mode`` as the CLI packs ACGT input)."""
    from mash_tpu_torch.io.ingest import IngestPipeline

    folder = tempfile.mkdtemp(prefix="h100_bench_")
    path = os.path.join(folder, "input.fx")
    os.mkfifo(path)
    failed = []

    def write():
        try:
            with open(path, "wb") as f:
                f.write(text)
        except OSError as e:  # the reader went away: it reports why
            failed.append(e)

    writer = threading.Thread(target=write, daemon=True)
    writer.start()
    pipe = IngestPipeline([path], k, chunk_len, batch_rows,
                          pack_mode=pack_mode)
    try:
        batches = list(pipe.batches())
    finally:
        pipe.close()
        writer.join(timeout=1.0)
        if writer.is_alive():
            # the reader never opened the pipe: open it so the writer ends
            with open(path, "rb") as f:
                while f.read(1 << 20):
                    pass
            writer.join()
        shutil.rmtree(folder)
    if failed:
        raise RuntimeError("the ingest stopped reading: %s" % failed[0])
    return batches
