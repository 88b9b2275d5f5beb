"""Host <-> device copies that do not block the host.

The counterpart of ``jax.device_put`` and ``copy_to_host_async`` in
``mash_tpu``: a copy from pageable host memory makes the host wait until
the card has run everything queued before it, so a streaming path that
uploads each batch that way never runs ahead of the card.  Both classes
copy from or into pinned (page-locked) host memory and guard it with a
CUDA event, on the current stream, so the caching allocator's stream
order keeps freed device tensors safe.

- :class:`Uploader`: sends a pinned array as it is, any other through a
  ring of pinned buffers, one batch a slot.
- :class:`Readback`: a device-to-host copy started now, read later.
- :func:`to_host`: a blocking read-back, where the host needs the
  answer now.

Each place where the host blocks on the card is a ``wait:*`` stage
(``utils.profiling``): ``wait:upload_slot``, ``wait:readback`` and
``wait:to_host``.  ``Uploader.upload`` as a whole is the stage
``transfer:upload``; the counters ``transfer:direct_bytes`` and
``transfer:staged_bytes`` count the bytes of each of its two routes.

On the CPU both are identities: nothing is pinned (PyTorch cannot pin
memory without CUDA) and nothing waits.  On CUDA a failure to pin raises;
there is no fallback to pageable memory.
"""

from __future__ import annotations

import numpy as np
import torch

from mash_tpu_torch.utils.profiling import count, stage


class Uploader:
    """Uploads numpy arrays to ``device`` without waiting for the card.

    ``upload(arr)`` takes the next slot of a ring of ``slots`` and picks
    its route from where ``arr``'s memory lives:

    - a writable array in pinned memory (an ``io.ingest.IngestPipeline``
      batch on a CUDA host) is sent as it is:
      ``.to(device, non_blocking=True)`` straight from it (counter
      ``transfer:direct_bytes``);
    - any other array (pageable, read-only) is copied into the slot's own
      pinned buffer first and sent from there (counter
      ``transfer:staged_bytes``), so the caller may reuse it at once.  A
      slot's buffer grows to the largest batch it has staged; the ring
      pins at most ``slots`` times that.

    Either way the slot records an event after the copy and keeps what
    the copy reads until the event has completed: the host waits only
    for the copy that last used the slot, so it runs up to ``slots``
    batches ahead of the copies.  The reference to a caller's pinned
    array is what keeps the direct route safe.  The copy reads it
    through a ``torch.from_numpy`` alias, for which torch's caching host
    allocator records no event, so a batch its holder dropped could
    otherwise come back as the ingest's next buffer while the card still
    reads it.  The caller must not write a pinned array while its copy
    may be in flight (the ingest pipeline never writes a shipped batch).
    """

    def __init__(self, device, slots: int = 3):
        if slots < 1:
            raise ValueError("an uploader needs at least one slot")
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._bufs = [None] * slots  # the slots' own pinned uint8 tensors
        self._held = [None] * slots  # a caller's pinned array in flight
        self._events = [None] * slots
        self._next = 0

    def pinned_bytes(self) -> int:
        """Bytes of pinned host memory the ring's own buffers hold."""
        return sum(b.numel() for b in self._bufs if b is not None)

    def upload(self, arr: np.ndarray) -> torch.Tensor:
        """``arr`` as a tensor on the device (queued, not yet there).

        The stage ``transfer:upload`` times the host's part on either
        route: the wait for the slot (``wait:upload_slot``, nested), the
        copy into it where the route stages, and the start of the copy to
        the card."""
        with stage("transfer:upload"):
            arr = np.ascontiguousarray(arr)
            if not self._cuda:
                return torch.from_numpy(arr if arr.flags.writeable
                                        else arr.copy())
            i = self._next
            self._next = (i + 1) % len(self._bufs)
            if self._events[i] is not None:
                # the copy that last read this slot must be done before
                # the slot is overwritten or lets go of the caller's array
                with stage("wait:upload_slot"):
                    self._events[i].synchronize()
            self._held[i] = None
            src = arr.reshape(-1).view(np.uint8)
            # torch wraps no read-only array without a warning
            alias = torch.from_numpy(src) if src.flags.writeable else None
            if alias is not None and alias.is_pinned():
                count("transfer:direct_bytes", src.nbytes)
                host = self._held[i] = alias
            else:
                count("transfer:staged_bytes", src.nbytes)
                host = self._stage(i, src, alias)
            dev = host.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self._events[i] = event
            return dev.view(_torch_dtype(arr.dtype)).view(arr.shape)

    def _stage(self, i: int, src: np.ndarray, alias) -> torch.Tensor:
        """``src``'s bytes copied into slot ``i``'s pinned buffer."""
        nbytes = src.nbytes
        buf = self._bufs[i]
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                              pin_memory=True)
            self._bufs[i] = buf
        host = buf[:nbytes]
        if alias is not None:
            # torch's copy splits a large batch over its intra-op
            # threads; one thread copies at a third of the rate
            host.copy_(alias)
        else:
            np.copyto(host.numpy(), src)
        return host


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
