"""Profiling and observability hooks (x3_tpu.utils.profiling).

* `span(name, **counts)` — a named, timed region, always recorded in
  memory (`RECORDER`): the spans of one call share the id of its outermost
  span and each names its parent, across the read-ahead thread and the
  scatter worker too.  While a torch profiler runs (or
  `torch.autograd.profiler.emit_nvtx`), each span also enters a
  `record_function` of its name, so it shows in `trace()`'s Chrome trace
  and in NVTX;
* `spans(since_ns)` and `counters()` — snapshots of the recorded spans and
  of the running totals by name, and `profiler_ns(t)` — a span's clock
  (`time.perf_counter_ns`) on the profiler's (Unix nanoseconds);
* `trace(logdir)` — a torch.profiler recording of the enclosed region
  (CPU and, with a card, CUDA activity), written to `logdir` as a Chrome
  trace (chrome://tracing, Perfetto);
* `aot_compile(...)` — builds the kernels and runs one encode and one
  decode at a batch shape, so the first real call pays for neither the
  nvcc build nor the libraries' loading and the allocator's growth (the
  port's counterpart of x3_tpu's ahead-of-time compile);
* module-level `logger` — the library's logging channel.

The spans the port records and what each covers:

  x3.decode_streams   multifile.decode_streams, a whole call (archives, frames)
  x3.decode.index     its archives' headers and frame indexes (archives)
  x3.decode.worklist  its frames cut into batches (multifile.decode_batches),
                      and decode_runs' host buffers for them
  x3.decode.scatter   the outputs' allocation, then each batch's copy into
                      them (bytes; minflt: the thread's minor page faults);
                      with two or more batches a call's copies run on its
                      scatter worker, the allocation on the caller's thread.
                      The allocation's pooled_bytes: output bytes taken
                      from utils.outpool (outputs of 32 MiB or more);
                      reused_bytes: those of them on a recycled mapping
  x3.scatter_wait     the caller on the scatter worker: each copy queued
                      (blocked while the one before is still queued), and
                      the wait for the last copy before the call returns
  x3.decode.stage     multifile.decode_runs, a batch's runs copied into its
                      host buffer on the read-ahead thread (bytes)
  x3.pool_wait        models.staging.BufferPool.acquire
  x3.decode.launch    models.decoder.decode_frames_indexed up to the
                      read-back's wait: the host's enqueue (h2d_bytes)
  x3.device_wait      models.staging.wait, the host blocked on a read-back's
                      event (d2h_bytes, counted by staging.to_host)
  x3.prefetch_wait    utils.io.prefetch_iter, the consumer blocked on the
                      read-ahead queue
  x3.writer_wait      utils.io.AsyncWriter, the producer blocked on the
                      writer's queue or its drain (the scatter worker's
                      waits are x3.scatter_wait)
  x3.kernels.build    ops._build.load, one kernel library built (built: nvcc
                      ran) and loaded (loaded)
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import logging
import os
import resource
import struct
import sys
import threading
import time
from typing import NamedTuple

logger = logging.getLogger("x3_tpu_torch")

CAPACITY = 65536  # spans the ring holds
MAX_COUNTS = 4  # distinct counts a span may carry
_ROW = struct.Struct(f"<{8 + MAX_COUNTS}q")  # id, call, parent, thread, start, end, name, keys, counts
_KEY_BITS = 16  # each count's key (index + 1, 0 for none) packed into one column
_END, _END_AT = struct.Struct("<q"), 5 * 8  # a row's end_ns
_NO_COUNTS = (0,) * MAX_COUNTS

_current: contextvars.ContextVar = contextvars.ContextVar("x3_span", default=None)  # the innermost open span
_ids = itertools.count(1)  # span ids, process-wide; 0 is "no parent"


class Span(NamedTuple):
    """One recorded span; times in ns of time.perf_counter_ns."""

    name: str
    start_ns: int
    end_ns: int
    call: int  # the id of the call's outermost span (its own id for a root)
    id: int
    parent: int  # 0 for a root
    thread: int  # threading.get_ident() of the thread it ran on
    counts: dict


class SpanLog(list):
    """spans()' snapshot: Span records in the order they ended.  `wrapped`
    is true when the ring overwrote a span that ended at or after the
    snapshot's since_ns: the log then lacks some of that window."""

    wrapped: bool = False


class Recorder:
    """Spans in a ring of `capacity` fixed-size rows in one preallocated
    buffer (the oldest overwritten first), and running totals by name
    (count, ns, summed counts) that are never evicted.  One lock keeps
    both whole under several threads."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self._buf = bytearray(_ROW.size * capacity)
        self._n = 0  # spans recorded
        self._lost_end = -1  # the latest end among overwritten spans
        self._by_name: dict[str, list] = {}  # name: [index, count, ns, {count key: sum}]
        self._keys: dict[str, int] = {}
        self._lock = threading.Lock()

    @property
    def nbytes(self) -> int:
        return len(self._buf)

    def span(self, name: str, **counts) -> _Span:
        return _Span(self, name, counts)

    def record(self, name: str, start_ns: int, end_ns: int, call: int, sid: int, parent: int,
               thread: int, counts: dict) -> None:
        if len(counts) > MAX_COUNTS:
            raise ValueError(f"span {name!r} carries {len(counts)} counts; at most {MAX_COUNTS}")
        with self._lock:
            n = self._n
            self._n = n + 1
            tot = self._by_name.get(name)
            if tot is None:
                tot = self._by_name[name] = [len(self._by_name), 0, 0, {}]
            tot[1] += 1
            tot[2] += end_ns - start_ns
            keys, values = 0, _NO_COUNTS
            if counts:
                values = [0] * MAX_COUNTS
                sums = tot[3]
                for j, (k, v) in enumerate(counts.items()):
                    keys |= (self._keys.setdefault(k, len(self._keys)) + 1) << (_KEY_BITS * j)
                    values[j] = v
                    sums[k] = sums.get(k, 0) + v
            at = (n % self.capacity) * _ROW.size
            if n >= self.capacity:
                self._lost_end = max(self._lost_end, _END.unpack_from(self._buf, at + _END_AT)[0])
            _ROW.pack_into(self._buf, at, sid, call, parent, thread, start_ns, end_ns, tot[0], keys, *values)

    def spans(self, since_ns: int | None = None) -> SpanLog:
        """The spans held that ended at or after since_ns (all held for
        None), oldest first; `wrapped` says whether some were lost."""
        with self._lock:
            n, buf, lost = self._n, bytes(self._buf), self._lost_end
            names = list(self._by_name)
            keys = list(self._keys)
        lo = max(0, n - self.capacity)
        out = SpanLog()
        out.wrapped = n > self.capacity and lost >= (since_ns or 0)
        mask = (1 << _KEY_BITS) - 1
        for i in range(lo, n):
            sid, call, parent, thread, t0, t1, name_ix, packed, *values = _ROW.unpack_from(
                buf, (i % self.capacity) * _ROW.size)
            if since_ns is not None and t1 < since_ns:
                continue
            counts = {}
            for j in range(MAX_COUNTS):
                k = (packed >> (_KEY_BITS * j)) & mask
                if k:
                    counts[keys[k - 1]] = values[j]
            out.append(Span(names[name_ix], t0, t1, call, sid, parent, thread, counts))
        return out

    def counters(self) -> dict:
        """{name: {"count": spans, "ns": their summed durations, <count>:
        its sum}} over every span recorded since the process started."""
        with self._lock:
            return {name: {"count": count, "ns": ns, **sums}
                    for name, (_, count, ns, sums) in self._by_name.items()}


class _Span:
    """The context manager span() returns.  add(**counts) adds to its
    counts while it is open."""

    __slots__ = ("_rec", "name", "counts", "id", "call", "parent", "_prev", "_t0", "_rf")

    def __init__(self, rec: Recorder, name: str, counts: dict):
        self._rec, self.name, self.counts = rec, name, counts

    def __enter__(self) -> _Span:
        prev = _current.get()
        self.id = next(_ids)
        self.call, self.parent = (self.id, 0) if prev is None else (prev.call, prev.id)
        self._prev = prev
        _current.set(self)
        self._rf = None
        prof = sys.modules.get("torch.autograd.profiler")  # without it no profiler can run
        if prof is not None and getattr(prof, "_is_profiler_enabled", False):
            import torch

            self._rf = torch.profiler.record_function(self.name)
            self._t0 = time.perf_counter_ns()  # read just before the event's own start, which it then matches
            self._rf.__enter__()
        else:
            self._t0 = time.perf_counter_ns()
        return self

    def add(self, **counts) -> None:
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _current.set(self._prev)
        self._rec.record(self.name, self._t0, t1, self.call, self.id, self.parent, threading.get_ident(),
                         self.counts)


RECORDER = Recorder()


def span(name: str, **counts) -> _Span:
    """A span of `name` around the enclosed region, recorded in RECORDER,
    with integer `counts` (more with .add() while it is open)."""
    return _Span(RECORDER, name, counts)


def add(**counts) -> None:
    """Add counts to the innermost span open in this context, if any."""
    sp = _current.get()
    if sp is not None:
        sp.add(**counts)


def spans(since_ns: int | None = None) -> SpanLog:
    """RECORDER's spans that ended at or after since_ns (Recorder.spans)."""
    return RECORDER.spans(since_ns)


def counters() -> dict:
    """RECORDER's running totals by name (Recorder.counters)."""
    return RECORDER.counters()


def profiler_ns(t_ns: int) -> int:
    """A time of the spans' clock (time.perf_counter_ns) on the
    profiler's clock, Unix nanoseconds (time.time_ns): the offset is the
    one read between two perf_counter_ns reads closest together."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) // 2)
    return t_ns + best[1]


def minor_faults() -> int:
    """The calling thread's minor page faults so far (getrusage)."""
    return resource.getrusage(resource.RUSAGE_THREAD).ru_minflt


@contextlib.contextmanager
def trace(logdir):
    """Record the enclosed region with torch.profiler and write it to
    `logdir` as a Chrome trace.  One recording with no schedule: no cycle
    boundary drops events.  Yields the profiler; the trace's path is its
    `trace_path` attribute once the region has ended."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities, acc_events=True)  # keep every event of the recording
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()  # the region's kernels end inside the recording
        prof.stop()
        path = os.path.join(str(logdir), f"trace-{os.getpid()}-{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        prof.trace_path = path
        n_device = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
        logger.info("trace: %d device events kept, written to %s", n_device, path)


def aot_compile(batch_frames: int, params=None, decode: bool = True, *, device="cuda") -> dict:
    """Build the kernels (on a card) and run one encode, and with `decode`
    one decode, of `batch_frames` frames on `device`.  Returns
    {"encode": fn(samples, n_valid) -> encode_frames' dict, "decode":
    fn(payload, n_samples, payload_lens) -> (samples, err)}, taking numpy
    arrays or tensors and running on `device` at the default rungs."""
    import numpy as np
    import torch

    from ..device import resolve_device
    from ..ops.decode_kernel import decode_frames
    from ..ops.encode_kernel import encode_frames, frame_geometry
    from ..params import Parameters

    dev = resolve_device(device)
    params = params or Parameters()
    if dev.type == "cuda":
        from ..ops import _build

        _build.build_all()

    def on_dev(a):
        return torch.as_tensor(a).to(dev)

    def enc(samples, n_valid):
        return encode_frames(on_dev(samples), on_dev(n_valid), params)

    def dec(payload, n_samples, payload_lens):
        return decode_frames(on_dev(payload), on_dev(n_samples), on_dev(payload_lens), params)

    S, _, _, W = frame_geometry(params)
    n_valid = np.zeros(batch_frames, np.int32)
    enc(np.zeros((batch_frames, S), np.int16), n_valid)
    out = {"encode": enc}
    if decode:
        dec(np.zeros((batch_frames, W * 4), np.uint8), n_valid, n_valid)
        out["decode"] = dec
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    logger.info("warmed the pipelines for batch_frames=%d on %s", batch_frames, dev)
    return out
