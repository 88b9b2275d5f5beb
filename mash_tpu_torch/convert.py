"""Carry sketch states and parameters between numpy and the port.

``mash_tpu`` (the JAX reference) hands out host values as numpy arrays:
states as ``(uint64 hashes, int64 counts)`` and parameters as a
``SketchParams`` dataclass.  These helpers turn them into the port's
tensors and dataclass and back, without importing ``mash_tpu``: the
tests pass the same inputs to both packages through them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mash_tpu_torch.core.params import SketchParams


def state_from_numpy(hashes_u64, counts, device="cpu"):
    """``(uint64 [.., s], int [.., s])`` -> ``(int64, int64)`` tensors."""
    h = np.ascontiguousarray(hashes_u64, dtype=np.uint64).view(np.int64)
    c = np.ascontiguousarray(counts, dtype=np.int64)
    return torch.from_numpy(h).to(device), torch.from_numpy(c).to(device)


def state_to_numpy(state):
    """``(int64, int64)`` tensors -> ``(uint64, int64)`` numpy arrays."""
    h, c = state
    return h.cpu().numpy().view(np.uint64), c.cpu().numpy()


def db_table_from_numpy(db_hashes_u64, seg_starts, ref_ids, device="cpu"):
    """A screen DB table as ``mash_tpu`` holds it (``build_db_table``'s
    uint64 hashes, int64 CSR starts, int32 reference ids) -> int64,
    int64 and int32 tensors on ``device``."""
    h = np.ascontiguousarray(db_hashes_u64, dtype=np.uint64).view(np.int64)
    return (
        torch.from_numpy(h).to(device),
        torch.from_numpy(np.ascontiguousarray(seg_starts, np.int64)).to(device),
        torch.from_numpy(np.ascontiguousarray(ref_ids, np.int32)).to(device),
    )


def params_from_numpy(ref_params) -> SketchParams:
    """The port's SketchParams with the same field values as a
    reference ``SketchParams`` (or a dict of its fields)."""
    if not isinstance(ref_params, dict):
        ref_params = {
            f.name: getattr(ref_params, f.name)
            for f in dataclasses.fields(SketchParams)
        }
    return SketchParams(**ref_params)
