"""Multi-process runs and multi-device sharding.

The counterpart of ``mash_tpu.parallel``: ``multihost`` coordinates
processes over ``torch.distributed`` (gloo, host tensors), ``mesh``
shards the three core workloads over one process's local devices.

Attribute access is lazy (PEP 562): ``mash_tpu_torch.parallel.multihost``
must be importable before the process group exists, so this package
does not pull ``mesh`` and the device ops at import time.
"""

__all__ = [
    "default_mesh",
    "sharded_sketch_chunks",
    "sharded_pairwise",
    "sharded_screen_counts",
]


def __getattr__(name):
    if name in __all__:
        from mash_tpu_torch.parallel import mesh

        return getattr(mesh, name)
    raise AttributeError(name)
