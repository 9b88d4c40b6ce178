"""The port's span recorder (x3_tpu_torch.utils.profiling) on the CPU: the
span tree of a decode_streams call, the shared waits' spans, the running
totals under several threads, the ring's bound, the profiler's clock, and
the benchmark's readers of the spans (x3bench/spans.py)."""

import ctypes.util
import io
import sys
import threading
import time

import numpy as np
import pytest
import torch

import x3_tpu_torch as xt
from x3_tpu_torch import multifile
from x3_tpu_torch.models import staging
from x3_tpu_torch.utils import profiling
from x3_tpu_torch.utils.io import AsyncWriter, prefetch_iter

PRM = xt.Parameters(block_len=4, blocks_per_frame=8)
DECODE_SPANS = {"x3.decode_streams", "x3.decode.index", "x3.decode.worklist", "x3.decode.scatter",
                "x3.prefetch_wait", "x3.decode.stage", "x3.pool_wait", "x3.decode.launch",
                "x3.scatter_wait"}  # the spans of a call of two or more batches


def _archives(lengths, seed=0):
    rng = np.random.default_rng(seed)
    xs = [rng.integers(-60, 60, n).astype(np.int16) for n in lengths]
    head = xt.build_archive_header(96000, PRM)
    return xs, [head + xt.encode(x, PRM, device="cpu").data for x in xs]


def _call_spans(fn):
    """fn()'s result and the spans of this thread's one root among them."""
    t0 = time.perf_counter_ns()
    out = fn()
    log = profiling.spans(t0)
    assert not log.wrapped
    me = threading.get_ident()
    roots = [s for s in log if s.parent == 0 and s.thread == me and s.start_ns >= t0]
    assert len(roots) == 1, roots
    return out, roots[0], [s for s in log if s.call == roots[0].id and s.parent != 0]


def test_decode_streams_span_tree():
    """One CPU call over four archives (two batches of 8 frames): every span
    that runs on the CPU, one call id, parents as the code nests them, the
    stage on the read-ahead thread and the batches' copies on the scatter
    worker under the caller's call, and the counts."""
    xs, arcs = _archives([100, 1, 0, 333])
    threads = threading.active_count()
    out, root, kids = _call_spans(lambda: multifile.decode_streams(arcs, batch_frames=8, device="cpu"))
    assert threading.active_count() == threads
    for (got, _), x in zip(out, xs):
        np.testing.assert_array_equal(got, x)
    assert root.name == "x3.decode_streams" and root.call == root.id
    frames = sum(-(-len(x) // PRM.samples_per_frame) for x in xs)
    assert root.counts == {"archives": 4, "frames": frames}
    by = {}
    for s in kids:
        by.setdefault(s.name, []).append(s)
    assert set(by) == DECODE_SPANS - {"x3.decode_streams"}
    assert {s.call for s in kids} == {root.id}
    stages = {s.id for s in by["x3.decode.stage"]}
    me = threading.get_ident()
    alloc, *copies = by["x3.decode.scatter"]  # in the order they ended
    worker = {s.thread for s in copies}
    assert len(worker) == 1 and worker.isdisjoint({me} | {s.thread for s in by["x3.decode.stage"]})
    for s in kids:
        assert s.parent in (stages if s.name == "x3.pool_wait" else {root.id}), s
        assert s.thread not in worker | {me} or root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns, s
    batches = -(-frames // 8)
    assert len(by["x3.decode.index"]) == 1 and by["x3.decode.index"][0].counts == {"archives": 4}
    assert len(by["x3.decode.worklist"]) == 2  # the batches, then decode_runs' buffers
    assert len(by["x3.decode.launch"]) == len(by["x3.decode.stage"]) == len(by["x3.pool_wait"]) == batches
    assert len(by["x3.prefetch_wait"]) == batches + 1  # the last one takes the end of the batches
    assert len(by["x3.decode.scatter"]) == batches + 1  # the outputs' allocation, then each batch
    assert alloc.thread == me and alloc.counts["bytes"] == 0
    assert alloc.counts["pooled_bytes"] == alloc.counts["reused_bytes"] == 0  # every output under 32 MiB
    assert all(a.end_ns <= b.start_ns for a, b in zip(copies, copies[1:]))  # one copy at a time
    assert sum(s.counts["bytes"] for s in by["x3.decode.scatter"]) == 2 * sum(len(x) for x in xs)
    assert len(by["x3.scatter_wait"]) == batches + 1  # each copy queued, then the last one's wait
    assert all(s.counts["minflt"] >= 0 for s in by["x3.decode.scatter"])
    assert all(s.counts == {"h2d_bytes": 0} for s in by["x3.decode.launch"])  # the CPU copies nothing
    assert sum(s.counts["bytes"] for s in by["x3.decode.stage"]) > 0
    assert {s.thread for s in by["x3.decode.stage"] + by["x3.pool_wait"]} != {me}
    assert all(s.thread == me for n in ("x3.decode.index", "x3.decode.worklist", "x3.scatter_wait",
                                        "x3.prefetch_wait", "x3.decode.launch") for s in by[n])


def test_decode_streams_one_batch_spans():
    """A call of one batch starts no scatter worker: the outputs'
    allocation and the batch's copy are x3.decode.scatter spans on the
    caller's thread, and nothing waits on a worker (no x3.scatter_wait)."""
    xs, arcs = _archives([100, 1, 0, 33])
    threads = threading.active_count()
    out, root, kids = _call_spans(lambda: multifile.decode_streams(arcs, batch_frames=8, device="cpu"))
    assert threading.active_count() == threads
    for (got, _), x in zip(out, xs):
        np.testing.assert_array_equal(got, x)
    by = {}
    for s in kids:
        by.setdefault(s.name, []).append(s)
    assert set(by) == DECODE_SPANS - {"x3.decode_streams", "x3.scatter_wait"}
    assert len(by["x3.decode.launch"]) == 1
    me = threading.get_ident()
    assert [(s.thread, s.parent, s.counts["bytes"]) for s in by["x3.decode.scatter"]] == [
        (me, root.id, 0), (me, root.id, 2 * sum(len(x) for x in xs))]


def test_two_threads_decoding_at_once():
    """Two threads call decode_streams at once: each call has a tree of its
    own, and the running totals grow by the sum of both calls' spans."""
    _, arcs = _archives([70, 200, 5], seed=1)
    before = profiling.counters()
    t0 = time.perf_counter_ns()
    outs, errors = [None, None], []

    def body(i):
        try:
            outs[i] = multifile.decode_streams(arcs, batch_frames=4, device="cpu")
        except BaseException as e:  # noqa: BLE001 - re-raised on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors and all(o is not None for o in outs)
    log = profiling.spans(t0)
    roots = [s for s in log if s.parent == 0 and s.name == "x3.decode_streams" and s.start_ns >= t0]
    assert len(roots) == 2 and roots[0].call != roots[1].call
    trees = [[s.name for s in log if s.call == r.id] for r in roots]
    assert sorted(trees[0]) == sorted(trees[1])
    after = profiling.counters()
    for name in DECODE_SPANS:
        mine = [s for s in log if s.name == name and s.call in {r.id for r in roots}]
        assert after[name]["count"] - before.get(name, {}).get("count", 0) >= len(mine) > 0
    assert after["x3.decode.index"]["archives"] - before["x3.decode.index"]["archives"] >= 6


def test_recorder_totals_under_many_threads():
    """Eight threads record spans at once, switching every microsecond: no
    span or count is lost from the ring or the totals."""
    rec = profiling.Recorder(capacity=16384)
    n, k = 8, 1500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def body(i):
            for j in range(k):
                with rec.span("x3.test", bytes=i + 1) as sp:
                    sp.add(items=1)
        threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    tot = rec.counters()["x3.test"]
    assert tot["count"] == n * k and tot["items"] == n * k and tot["bytes"] == k * n * (n + 1) // 2
    log = rec.spans()
    assert len(log) == n * k and not log.wrapped
    assert len({s.id for s in log}) == n * k
    assert tot["ns"] == sum(s.end_ns - s.start_ns for s in log)
    assert all(s.counts == {"bytes": s.counts["bytes"], "items": 1} for s in log)


def test_ring_is_bounded_and_reports_a_wrap():
    """The ring keeps its newest `capacity` spans in one preallocated buffer;
    spans(since_ns) says whether it lost a span that ended at or after
    since_ns, and the totals keep everything."""
    assert profiling.RECORDER.capacity == 65536 and profiling.RECORDER.nbytes <= 8_000_000
    rec = profiling.Recorder(capacity=16)
    size = rec.nbytes
    for i in range(16):
        rec.record("x3.a", 100 * i, 100 * i + 50, i + 1, i + 1, 0, 1, {"bytes": i})
    assert not rec.spans().wrapped and len(rec.spans()) == 16
    for i in range(16, 40):
        rec.record("x3.a", 100 * i, 100 * i + 50, i + 1, i + 1, 0, 1, {"bytes": i})
    assert rec.nbytes == size
    log = rec.spans()
    assert len(log) == 16 and [s.id for s in log] == list(range(25, 41)) and log.wrapped
    assert rec.spans(100 * 23).wrapped  # span 24 (id) ended at 2,350 and is gone
    later = rec.spans(100 * 24)
    assert not later.wrapped and [s.id for s in later] == list(range(25, 41))
    assert rec.counters()["x3.a"] == {"count": 40, "ns": 40 * 50, "bytes": sum(range(40))}
    with pytest.raises(ValueError):
        rec.record("x3.b", 0, 1, 1, 1, 0, 1, dict.fromkeys("abcde", 1))


def test_no_record_function_without_a_profiler(monkeypatch):
    """With no profiler running a span makes no record_function (and so no
    NVTX range); under torch.profiler it makes one of its name."""
    made = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        made.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _, arcs = _archives([50])
    multifile.decode_streams(arcs, device="cpu")
    with profiling.span("x3.untraced"):
        pass
    assert made == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("x3.traced"):
            pass
    assert "x3.traced" in made


def test_span_start_on_the_profilers_clock():
    """Under torch.profiler on the CPU, each span's start put on the
    profiler's clock (profiler_ns) lies within 1 ms of the start of its
    record_function event.  The profiler records the CPU events of the
    thread that started it: the read-ahead thread's spans are not there."""
    _, arcs = _archives([300, 40])
    multifile.decode_streams(arcs, batch_frames=8, device="cpu")  # warm
    t0 = time.perf_counter_ns()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        multifile.decode_streams(arcs, batch_frames=8, device="cpu")
    finally:
        prof.stop()
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("x3."):
            events.setdefault(e.name(), []).append(e.start_ns())
    me = threading.get_ident()
    log = [s for s in profiling.spans(t0) if s.start_ns >= t0 and s.thread == me]
    assert {s.name for s in log} == DECODE_SPANS - {"x3.decode.stage", "x3.pool_wait"}
    for s in log:
        at = profiling.profiler_ns(s.start_ns)
        assert min(abs(at - e) for e in events[s.name]) < 1_000_000, s.name


def test_shared_waits_are_spans(tmp_path, monkeypatch):
    """The read-ahead thread runs in the consumer's context (its spans join
    the consumer's call), the writer's waits, a read-back's event wait with
    the bytes read back, and a kernel library's build and load."""
    me = threading.get_ident()

    def src():
        for i in range(3):
            with profiling.span("x3.test.item"):
                item = i
            yield item

    with profiling.span("x3.test.root") as root:
        assert list(prefetch_iter(src(), depth=1)) == [0, 1, 2]
    log = [s for s in profiling.spans() if s.call == root.id]
    items = [s for s in log if s.name == "x3.test.item"]
    assert len(items) == 3 and all(s.parent == root.id and s.thread != me for s in items)
    assert sum(s.name == "x3.prefetch_wait" and s.thread == me for s in log) == 4

    with profiling.span("x3.test.write") as root:
        w = AsyncWriter(io.BytesIO())
        w.write(b"abc")
        w.drain()
        w.close()
    waits = [s for s in profiling.spans() if s.call == root.id and s.name == "x3.writer_wait"]
    assert len(waits) == 3 and all(s.parent == root.id for s in waits)

    class Event:
        synced = False

        def synchronize(self):
            self.synced = True

    ev = Event()
    staging._d2h.nbytes = 4096  # as to_host leaves it after a read-back of 4,096 bytes
    with profiling.span("x3.test.wait") as root:
        staging.wait(ev)
        staging.wait(None)  # the CPU: nothing to wait for, no span
    waits = [s for s in profiling.spans() if s.call == root.id and s.parent]
    assert ev.synced and [(s.name, s.counts) for s in waits] == [("x3.device_wait", {"d2h_bytes": 4096})]

    from x3_tpu_torch.ops import _build

    libc = ctypes.util.find_library("c")
    if libc is None:
        pytest.skip("no C library to load")
    monkeypatch.setattr(_build, "library_path", lambda name: tmp_path / f"{name}.so")
    monkeypatch.setattr(_build, "build", lambda name: libc)
    before = profiling.counters().get("x3.kernels.build", {"count": 0, "built": 0, "loaded": 0})
    assert _build.load("x3_tracing_test", "abs", 0, 1) is not None
    after = profiling.counters()["x3.kernels.build"]
    assert [after[k] - before[k] for k in ("count", "built", "loaded")] == [1, 1, 1]


class _Trace:
    def __init__(self, window, device):
        self.window, self.device = window, device

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.device)


def test_readers_of_the_spans(monkeypatch):
    """The benchmark's span readers on a CPU decode window: ms a call as
    the self time over the window's roots, counts per byte decoded, the
    share of output bytes on recycled pages (the pool's threshold set to
    64 bytes: the second call reuses the first's two larger outputs), the
    unnamed share of the device's idle time, and None with nothing to read."""
    from x3_tpu_torch.utils import outpool
    from x3bench import harness
    from x3bench import spans as xs

    monkeypatch.setattr(outpool, "THRESHOLD_BYTES", 64)
    monkeypatch.setattr(outpool, "POOL", outpool.OutputPool())
    _, arcs = _archives([400, 90, 7], seed=3)
    start = time.perf_counter()
    for _ in range(2):
        multifile.decode_streams(arcs, batch_frames=8, device="cpu")
    run = harness.Run(direction="decode", start=start, end=time.perf_counter(), trace=None)
    roots, members = xs.window_calls(run)
    assert len(roots) == 2 and all(s.call in {r.id for r in roots} for s in members)
    index = [s for s in members if s.name == "x3.decode.index"]

    def read(name):
        return harness.load_reader(name)(run)

    assert read("index_ms.decode") == pytest.approx(sum(s.end_ns - s.start_ns for s in index) / 2 / 1e6)
    for name in ("scatter_ms.decode", "prefetch_wait_ms.decode", "launch_ms.decode",
                 "scatter_faults_per_mb.decode", "scatter_wait_ms.decode"):
        assert read(name) >= 0
    waits = [s for s in members if s.name == "x3.scatter_wait"]
    assert read("scatter_wait_ms.decode") == pytest.approx(sum(s.end_ns - s.start_ns for s in waits) / 2 / 1e6)
    for name in ("device_wait_ms.decode", "copy_bytes_per_mb.decode", "idle_unnamed_pct.decode"):
        assert read(name) is None  # no event, no copy and no device on the CPU
    assert read("out_reuse_pct.decode") == pytest.approx(100 * (800 + 180) / (2 * 2 * (400 + 90 + 7)))
    assert read("index_ms.encode") is None
    empty = harness.Run(direction="decode", start=0.0, end=1e-3, trace=None)  # long before any call
    for name in ("launch_ms.decode", "out_reuse_pct.decode"):
        assert harness.load_reader(name)(empty) is None

    # A root from 0 to 10 ms with children at 1-3 and 2-4 ms: 7 ms of self time.
    S = profiling.Span
    root = S("x3.r", 0, 10_000_000, 1, 1, 0, 1, {})
    kids = [S("x3.k", 1_000_000, 3_000_000, 1, 2, 1, 1, {}), S("x3.k", 2_000_000, 4_000_000, 1, 3, 1, 1, {})]
    assert xs.self_ns(root, kids) == 7_000_000
    assert xs.intersect([(0, 2), (3, 5)], [(1, 4)]) == [(1, 2), (3, 4)]

    # The device idle through a call of which a child span names about three quarters.
    t0 = time.perf_counter_ns()
    with profiling.span("x3.test.call"):
        with profiling.span("x3.test.child"):
            time.sleep(0.03)
        time.sleep(0.01)
    mine = sorted((s for s in profiling.spans(t0) if s.name.startswith("x3.test.")), key=lambda s: s.name)
    call, child = mine
    a, b = (profiling.profiler_ns(call.start_ns) * 1e-9, profiling.profiler_ns(call.end_ns) * 1e-9)
    unnamed = harness.load_reader("idle_unnamed_pct.decode")
    tr = _Trace((a - 0.002, b + 0.002), [(a - 0.002, a - 0.001)])  # busy before the call only
    named = (child.end_ns - child.start_ns) / (call.end_ns - call.start_ns)
    assert unnamed(harness.Run(direction="decode", trace=tr)) == pytest.approx(100 * (1 - named), abs=0.01)
    assert unnamed(harness.Run(direction="decode", trace=_Trace((a, b), []))) is None  # a device never busy
