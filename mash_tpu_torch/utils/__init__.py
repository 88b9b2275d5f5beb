"""Cross-cutting utilities (device choice, profiling, timing)."""

from mash_tpu_torch.utils.device import resolve_device
from mash_tpu_torch.utils.profiling import maybe_trace, stage, stage_report

__all__ = ["maybe_trace", "resolve_device", "stage", "stage_report"]
