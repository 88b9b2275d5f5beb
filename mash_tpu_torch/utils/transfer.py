"""Host <-> device copies that do not block the host.

The counterpart of ``jax.device_put`` and ``copy_to_host_async`` in
``mash_tpu``: a copy from pageable host memory makes the host wait until
the card has run everything queued before it, so a streaming path that
uploads each batch that way never runs ahead of the card.  Both classes
copy through pinned (page-locked) host memory and guard it with a CUDA
event, on the current stream, so the caching allocator's stream order
keeps freed device tensors safe.

- :class:`Uploader`: a ring of pinned buffers, one batch a slot.
- :class:`Readback`: a device-to-host copy started now, read later.
- :func:`to_host`: a blocking read-back, where the host needs the
  answer now.

Each place where the host blocks on the card is a ``wait:*`` stage
(``utils.profiling``): ``wait:upload_slot``, ``wait:readback`` and
``wait:to_host``.  ``Uploader.upload`` as a whole is the stage
``transfer:upload``.

On the CPU both are identities: nothing is pinned (PyTorch cannot pin
memory without CUDA) and nothing waits.  On CUDA a failure to pin raises;
there is no fallback to pageable memory.
"""

from __future__ import annotations

import numpy as np
import torch

from mash_tpu_torch.utils.profiling import stage


class Uploader:
    """Uploads numpy arrays to ``device`` without waiting for the card.

    ``upload(arr)`` copies ``arr`` into the next pinned slot of a ring of
    ``slots``, issues ``.to(device, non_blocking=True)`` from it and
    records the slot's event.  It waits only for the copy that last used
    that slot, so the host runs up to ``slots`` batches ahead of the
    copies.  The copy into the slot also means the caller may reuse
    ``arr`` at once (an ingest thread's buffer, say).  A slot grows to
    the largest batch it has held; the ring pins at most ``slots`` times
    that.
    """

    def __init__(self, device, slots: int = 3):
        if slots < 1:
            raise ValueError("an uploader needs at least one slot")
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._bufs = [None] * slots  # pinned uint8 tensors
        self._events = [None] * slots
        self._next = 0

    def pinned_bytes(self) -> int:
        """Bytes of pinned host memory the ring holds."""
        return sum(b.numel() for b in self._bufs if b is not None)

    def upload(self, arr: np.ndarray) -> torch.Tensor:
        """``arr`` as a tensor on the device (queued, not yet there).

        The stage ``transfer:upload`` times the host's part: the wait for
        the slot (``wait:upload_slot``, nested), the copy into it and the
        start of the copy to the card."""
        with stage("transfer:upload"):
            arr = np.ascontiguousarray(arr)
            if not self._cuda:
                return torch.from_numpy(arr if arr.flags.writeable
                                        else arr.copy())
            i = self._next
            self._next = (i + 1) % len(self._bufs)
            if self._events[i] is not None:
                # the copy that last read this slot must be done before
                # the slot is overwritten
                with stage("wait:upload_slot"):
                    self._events[i].synchronize()
            nbytes = arr.nbytes
            buf = self._bufs[i]
            if buf is None or buf.numel() < nbytes:
                buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                  pin_memory=True)
                self._bufs[i] = buf
            host = buf[:nbytes]
            src = arr.reshape(-1).view(np.uint8)
            if src.flags.writeable:
                # torch's copy splits a large batch over its intra-op
                # threads; one thread copies at a third of the rate
                host.copy_(torch.from_numpy(src))
            else:  # torch wraps no read-only array without a warning
                np.copyto(host.numpy(), src)
            dev = host.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self._events[i] = event
            return dev.view(_torch_dtype(arr.dtype)).view(arr.shape)


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


class Readback:
    """A device tensor's copy into pinned host memory, started at once.

    :meth:`numpy` waits on this copy's event alone (not on work queued
    after it) and returns the host array.  A CPU tensor is returned as
    it is.
    """

    def __init__(self, tensor: torch.Tensor):
        if tensor.device.type != "cuda":
            self._host, self._event = tensor, None
            return
        self._host = torch.empty(tensor.shape, dtype=tensor.dtype,
                                 pin_memory=True)
        with torch.cuda.device(tensor.device):
            self._host.copy_(tensor, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(tensor.device))

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            with stage("wait:readback"):
                self._event.synchronize()
        return self._host.numpy()


def to_host(tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` copied to host memory now: on a card the host waits for
    everything queued before the copy (stage ``wait:to_host``)."""
    with stage("wait:to_host"):
        return tensor.cpu()
