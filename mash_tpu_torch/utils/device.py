"""Which torch device the port's entry points run on."""

from __future__ import annotations

import os

import torch

DEVICE_ENV = "MASH_TPU_TORCH_DEVICE"


def resolve_device(device=None) -> torch.device:
    """The device to run on: ``device`` if given, else
    ``$MASH_TPU_TORCH_DEVICE``, else ``cuda``.

    Raises if CUDA is asked for (explicitly or by default) and no card
    is present: the CPU is used only when asked for.
    """
    if device is None:
        device = os.environ.get(DEVICE_ENV) or "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' or set "
            "%s=cpu to run on the CPU" % DEVICE_ENV
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %s" % dev)
    return dev
