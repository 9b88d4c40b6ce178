"""Host staging for the batch loops: pinned host memory and non-blocking
copies ordered by CUDA events, so the host fills and assembles one batch
while the card works on another.

On a CUDA device every transfer goes through pinned host memory with
non_blocking=True on the device's current stream, and the host reads a
read-back only after an event recorded behind it has completed.  On the
CPU the same calls take no copy and record no event: that is the device's
routing, not a fallback.  Nothing here catches a failed allocation or
copy.  The host's waits are spans (utils.profiling): x3.device_wait on a
read-back's event, with the bytes of the read-backs enqueued on this
thread since the last wait (d2h_bytes), and x3.pool_wait on a pool."""

from __future__ import annotations

import threading

import torch

from ..utils.profiling import span

_d2h = threading.local()  # bytes of this thread's read-backs not yet waited for


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of `t`, enqueued on its device's current stream into a
    new pinned tensor: read it only after an event recorded later on that
    stream has completed (record, wait).  A CPU tensor is returned as it is."""
    if not t.is_cuda:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    _d2h.nbytes = getattr(_d2h, "nbytes", 0) + host.nbytes
    return host


def host_empty(shape, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """An empty host tensor to fill and copy to `device`: pinned for a CUDA
    device (from the caching host allocator, so a block freed by an
    earlier batch is reused), plain memory for the CPU."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


def record(device: torch.device) -> torch.cuda.Event | None:
    """An event behind everything enqueued so far on `device`'s current
    stream (None on the CPU, whose work is done when the call returns)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def wait(event: torch.cuda.Event | None) -> None:
    """Block the host until `event` has completed (no-op for None)."""
    if event is not None:
        nbytes, _d2h.nbytes = getattr(_d2h, "nbytes", 0), 0
        with span("x3.device_wait", d2h_bytes=nbytes):
            event.synchronize()


class Staging:
    """One staging buffer: int16 samples [F, S] and int32 n_valid [F]."""

    def __init__(self, frames: int, spf: int, device: torch.device):
        self.samples = host_empty((frames, spf), torch.int16, device)
        self.n_valid = host_empty(frames, torch.int32, device)


class BufferPool:
    """A fixed set of host buffers that a filling thread and a consuming
    loop pass between them.  acquire() blocks while every buffer is out;
    release() gives one back once nothing reads it any more (the copy of
    it to the device has completed); close() wakes a blocked acquire,
    which then raises, so a filling thread stops when its loop does."""

    def __init__(self, buffers):
        self._free = list(buffers)
        self._cv = threading.Condition()
        self._closed = False

    def acquire(self):
        with span("x3.pool_wait"), self._cv:
            self._cv.wait_for(lambda: self._free or self._closed)
            if self._closed:
                raise RuntimeError("the staging pool is closed")
            return self._free.pop()

    def release(self, buf) -> None:
        with self._cv:
            self._free.append(buf)
            self._cv.notify()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()


class StagingPool(BufferPool):
    """`n` staging buffers for batches of up to `frames` frames, pinned when
    `device` is a CUDA device.  A loop takes a buffer, fills it, submits
    the batch from it, and gives it back once that batch is finished: by
    then the H2D copy that read it has completed (finish waits on an event
    behind it), and a re-dispatch no longer needs it."""

    def __init__(self, n: int, frames: int, spf: int, device: torch.device):
        super().__init__(Staging(frames, spf, device) for _ in range(n))
