"""The least time one H100 needs for a window's work, from its shapes.

Counted from what the inputs ask for, never from the program's launches,
so the count stays the same whatever implements the work.  Each count is
a lower bound that no implementation giving Mash's hashes can beat:

- bytes: each base read once at 2 bits, and what the driver counts as
  its answers' ``out_bytes``: each finished genome's sketch written once
  (8 bytes a hash, 4 a count); for a screen, the DB's hashes read once
  and its uint32 counts written once in the window;
- integer operations: each k-mer window that no N touches needs its own
  MurmurHash3_x64_128 (no algebra carries one window's hash to the
  next), and of that only its 64-bit multiplications by constants are
  counted, three 32-bit multiplies each (low by low, wide, and the two
  cross terms), and nothing for the canonical strand, the rotations,
  shifts, xors and adds, the selection of the bottom s or the probes.

The peaks are the published ones of the H100 SXM (NVIDIA's data sheet,
at its 700 W limit): 3.35 TB/s of HBM3; 32-bit integer instructions at
64 lanes an SM, 132 SMs, 1.98 GHz boost.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_PER_S = 64 * 132 * 1.98e9


def mul64_per_hash(k: int) -> int:
    """64-bit multiplications by constants in MurmurHash3_x64_128 of k
    bytes: four a 16-byte block, two for each 8-byte half of the tail,
    four in the two final mixes."""
    tail = k % 16
    return 4 * (k // 16) + (2 if tail > 8 else 0) + (2 if tail else 0) + 4


def least_seconds(windows: int, bases: int, out_bytes: int, k: int):
    """``(seconds, bound)``: the larger of the byte and operation times,
    and which of the two it is."""
    t_bytes = (bases / 4 + out_bytes) / PEAK_BYTES_PER_S
    t_ops = windows * 3 * mul64_per_hash(k) / PEAK_INT32_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def share_pct(run):
    """A path's ``roofline_pct``: the least time of the window's work
    over the device's busy time in the traced window, in percent; None
    where the run was not traced."""
    if run.trace is None or not run.trace["busy_s"]:
        return None
    o = run.outcome
    least, _ = least_seconds(o.windows, o.bases, o.out_bytes,
                             run.config["kmer_size"])
    return 100.0 * least / run.trace["busy_s"]
