"""Window hash kernel: every k-mer window's MurmurHash3 and validity.

The counterpart of ``mash_tpu.ops.kmers.hash_chunk``, a ``jax.jit``
function that XLA fuses into one loop over the bytes.  The kernel
``csrc/hash_windows.cu`` computes in one pass what
``ops.kmers.hash_chunk_plain`` computes in a few hundred elementwise
passes, and writes nothing but the outputs: an int64 hash and a bool
for each window.  ``ops.kmers.hash_chunk`` sends a CUDA tensor here and
a CPU tensor to ``hash_chunk_plain``; this wrapper takes CUDA tensors
only.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from mash_tpu_torch.ops import cuda_build
from mash_tpu_torch.ops.kmers import alphabet_lut, complement_lut

# Kernel launches in this process (read and reset by chip_smoke.py).
LAUNCHES = {"hash_windows": 0}


@functools.lru_cache(maxsize=None)
def _launcher():
    """The kernel's C entry, built and bound once a process."""
    fn = cuda_build.load("hash_windows").hash_windows_launch
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [p, i64, i64, p, p, i32, ctypes.c_uint32, i32, i32, i32,
                   p, p, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _tables(alphabet: tuple):
    """``(alphabet_lut, complement_lut)`` of ``alphabet``, built once an
    alphabet (both functions are pure) and kept read-only; the kernel
    copies them into its launch parameters."""
    tables = alphabet_lut(alphabet), complement_lut(alphabet)
    for t in tables:
        t.flags.writeable = False
    return tables


def _as_rows(shape, k: int):
    """``(B, L, out_shape)`` of a ``[..., L]`` byte tensor's windows: the
    leading dims flattened to ``B`` rows, and the ``[..., L-k+1]`` shape
    the outputs take back.  Raises as ``hash_chunk`` does."""
    if not 1 <= k <= 32:
        raise ValueError("k must be in 1..32, got %d" % k)
    L = shape[-1]
    n = L - k + 1
    if n < 1:
        raise ValueError("chunk of %d bytes is shorter than k=%d" % (L, k))
    return math.prod(shape[:-1]), L, (*shape[:-1], n)


def hash_windows(
    seq: torch.Tensor,
    *,
    alphabet: tuple,
    k: int,
    seed: int,
    use64: bool,
    noncanonical: bool,
    preserve_case: bool,
):
    """``hash_chunk`` of a CUDA uint8 tensor ``[..., L]`` on the card.

    Returns ``(hashes int64 [..., L-k+1], valid bool [..., L-k+1])``,
    equal to ``ops.kmers.hash_chunk_plain``'s on every window, valid or
    not.  Launches on ``seq``'s device and its current stream.
    """
    if seq.dtype != torch.uint8:
        raise ValueError("seq must be uint8, got %s" % seq.dtype)
    if seed >> 32:
        raise ValueError("seed is uint32 in the reference")
    B, L, out_shape = _as_rows(tuple(seq.shape), k)
    if seq.device.type != "cuda":
        raise ValueError("hash_windows runs on cuda tensors, not %s"
                         % seq.device)
    dev = seq.device
    h = torch.empty(out_shape, dtype=torch.int64, device=dev)
    v = torch.empty(out_shape, dtype=torch.bool, device=dev)
    if B == 0:
        return h, v
    rows = seq.reshape(B, L).contiguous()
    alut, clut = _tables(tuple(alphabet))
    args = (rows.data_ptr(), B, L, alut.ctypes.data, clut.ctypes.data, k,
            seed, int(use64), int(noncanonical), int(preserve_case),
            h.data_ptr(), v.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        status = _launcher()(*args)
    cuda_build.check(status, "hash_windows")
    LAUNCHES["hash_windows"] += 1
    return h, v
