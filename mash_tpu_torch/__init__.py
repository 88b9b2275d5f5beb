"""mash-tpu-torch: the PyTorch/CUDA port of mash-tpu.

A second package beside ``mash_tpu`` (the JAX reference) that runs the
same MinHash sketching and distance estimation on an NVIDIA GPU:
k-mer hashing and bottom-s selection, and all-pairs sketch intersection,
run as hand-written CUDA kernels for Hopper (``ops/csrc``), each with a
plain PyTorch version that the CPU runs.  Outputs (``.msh`` bytes and
command stdout) equal ``mash_tpu``'s.

Entry points run on ``cuda`` unless the CPU is asked for
(``device="cpu"`` or ``MASH_TPU_TORCH_DEVICE=cpu``).  This package
imports neither ``jax`` nor ``mash_tpu``.
"""

from mash_tpu_torch._version import __version__

__all__ = ["__version__"]
