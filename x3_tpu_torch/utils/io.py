"""Bounded background file I/O for the file converters (x3_tpu.utils.io).

`write(2)`, `read(2)` and the device calls release the GIL, so a writer
thread with a bounded queue (AsyncWriter) and a read-ahead thread
(prefetch_iter) overlap file I/O with the conversion wherever a spare core
exists or the disk blocks.  The bytes written and the errors raised are
those of plain synchronous I/O: a failed write raises at the next
write()/drain()/close(), before the converter returns.  The caller's waits
are spans (utils.profiling): x3.prefetch_wait on the read-ahead queue,
x3.writer_wait on the writer's.
"""

from __future__ import annotations

import contextvars
import os
import queue
import threading
import time

from .profiling import span


def open_overwrite(path):
    """Open `path` for writing without O_TRUNC.

    Truncating a large existing output at open() releases its blocks
    synchronously; instead the file is opened in place and the caller
    truncates it to its final length just before closing.  Until then a
    shorter rewrite leaves stale bytes past the new end, so callers must
    truncate on the success path (a conversion that raises leaves partial
    output either way)."""
    fd = os.open(str(path), os.O_WRONLY | os.O_CREAT, 0o666)
    return os.fdopen(fd, "wb")


class AsyncWriter:
    """Write blocks to a file object from a background thread, in order.

    Single producer: the converters call write() from one thread.  Memory
    stays bounded by `depth` pending blocks.  The writer thread's exception
    is raised again on the next write()/drain()/close(); close() drains but
    does not close the underlying file (its owner may still patch headers,
    such as a WAV's sizes).

    One writer may serve several files (f=None): a block is then a (file,
    data) pair, and call(fn) queues a function to run on the writer's
    thread after the blocks before it, such as a file's closing, which
    runs after a write error too.

    wait_span: the name of the spans of the producer's waits.  The thread
    runs in a copy of the creator's context, so the spans of a queued
    function belong to the creator's call."""

    def __init__(self, f, depth: int = 2, wait_span: str = "x3.writer_wait"):
        self._f = f
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._exc: BaseException | None = None
        self._closed = False
        self._wait = wait_span
        self._t = threading.Thread(target=contextvars.copy_context().run, args=(self._run,), daemon=True)
        self._t.start()

    def _run(self) -> None:
        while True:
            blk = self._q.get()
            try:
                # A write error poisons the writer: later blocks are dropped
                # (resuming after a lost block would corrupt the stream) and
                # every later producer call raises it; functions queued by
                # call() (files' closings) still run.
                if callable(blk):
                    blk()
                elif blk is not None and self._exc is None:
                    f, data = blk if isinstance(blk, tuple) else (self._f, blk)
                    f.write(data)
            except BaseException as e:  # raised again on the producer's thread
                if self._exc is None:  # the first error
                    self._exc = e
            finally:
                self._q.task_done()
            if blk is None:
                return

    def _check(self) -> None:
        if self._exc is not None:
            raise self._exc

    def write(self, data) -> None:
        self._check()
        with span(self._wait):
            self._q.put(data)

    def call(self, fn) -> None:
        """Run fn() on the writer's thread after every block queued before
        it; an exception it raises is raised like a write error."""
        with span(self._wait):
            self._q.put(fn)

    def drain(self) -> None:
        """Block until every queued block is written; raise a write error."""
        with span(self._wait):
            self._q.join()
        self._check()

    def close(self) -> None:
        """Drain, stop the thread, and raise any pending write error."""
        if not self._closed:
            self._closed = True
            with span(self._wait):
                self._q.put(None)
                self._t.join()
        self._check()


def prefetch_iter(src, depth: int = 2):
    """Yield `src`'s items with up to `depth` of them read ahead on a
    background thread: the input-side mirror of AsyncWriter.

    Order is kept; an exception of the source is raised at the consuming
    point, after every item read before it.  Abandoning the generator stops
    the thread at the source's next item.  The thread runs in a copy of the
    consumer's context, so its spans belong to the consumer's call."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def run() -> None:
        try:
            for item in src:
                while not stop.is_set():
                    try:
                        q.put((False, item), timeout=0.05)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put((None, None))
        except BaseException as e:  # raised again on the consumer's thread
            if not stop.is_set():
                q.put((True, e))

    t = threading.Thread(target=contextvars.copy_context().run, args=(run,), daemon=True)
    t.start()
    try:
        while True:
            with span("x3.prefetch_wait"):
                kind, val = q.get()
            if kind is None:
                return
            if kind:
                raise val
            yield val
    finally:
        stop.set()
        # Unblock a producer waiting on a full queue; bound the clean-up
        # rather than hang on a source that never yields again (the thread
        # is a daemon either way).
        deadline = time.monotonic() + 1.0
        while t.is_alive() and time.monotonic() < deadline:
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.02)
