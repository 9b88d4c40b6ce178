"""The traced part of a `--trace 1` run: torch.profiler over a few seconds
of every client converting, read in memory (no trace file is written).

One process drives the card, so every client's device rows and CUDA
runtime calls are in one trace on one clock.  From it: the union of the
device's intervals (kernels, copies and sets) inside the traced window,
the union of the kernels' intervals over the whole trace, the device rows
that took most time, and the idle gaps by what the host was doing: the
CUDA runtime call that covered most of the gap, else the function of the
program that the clients' threads were in, from the harness's samples of
their Python stacks (`host:<module>.<function>`, or the benchmark's own
function, `host:x3bench.<module>.<function>`)."""

from __future__ import annotations

import bisect
from collections import defaultdict

from . import reduce

WINDOW = "x3bench.traced_window"  # the record_function span of the traced window


class Trace:
    def __init__(self, window, device, kernels, device_ops, idle_gaps):
        self.window = window  # (start, end) in seconds on the trace's clock
        self.device = device  # merged device intervals
        self.kernels = kernels  # merged kernel intervals
        self.device_ops = device_ops  # [[name, seconds], ...] most first
        self.idle_gaps = idle_gaps

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return reduce.covered(self.device, *self.window)

    @property
    def kernel_s(self) -> float:
        return sum(b - a for a, b in self.kernels)


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def stack_label(frame) -> str:
    """What a client's thread is in: the innermost function of the program
    (x3_tpu_torch) on its Python stack, as host:<module>.<function>, else
    the innermost of the benchmark's own (host:x3bench.<module>.<function>:
    an entry's own work, such as joining an archive's header to its
    frames, or the harness between calls)."""
    own = None
    f = frame
    while f is not None:
        path = f.f_code.co_filename.replace("\\", "/")
        for pkg, prefix in (("/x3_tpu_torch/", "host:"), ("/x3bench/", "host:x3bench.")):
            if pkg in path:
                mod = path.rsplit(pkg, 1)[1][: -len(".py")].replace("/", ".")
                label = f"{prefix}{mod}.{f.f_code.co_name}"
                if pkg == "/x3_tpu_torch/":
                    return label
                own = own or label
        f = f.f_back
    return own or "host"


def read(events, samples=()) -> Trace:
    """Reduce the profiler's kineto events to a Trace.  `samples`: the
    clients' stack labels as (seconds on the trace's clock, label)."""
    window = None
    dev, kern, runtime = [], [], []
    sums: dict = defaultdict(float)
    for e in events:
        name = e.name()
        a, b = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        if name == WINDOW:
            window = (a, b)
        elif str(e.device_type()).endswith("CUDA"):
            dev.append((a, b))
            if not _is_copy(name):
                kern.append((a, b))
            sums[reduce.clean_name(name)] += b - a
        elif name.startswith("cu") and b > a:
            runtime.append((a, b, name))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW} span")
    merged = reduce.union(dev)
    return Trace(window, merged, reduce.union(kern), reduce.top(sums),
                 _idle_gaps(merged, runtime, window, sorted(samples)))


def _host_label(samples, times, g0: float, g1: float) -> str:
    """The label most of the samples inside [g0, g1] give; for a gap too
    short to hold one, the sample nearest its middle."""
    lo, hi = bisect.bisect_left(times, g0), bisect.bisect_right(times, g1)
    if hi > lo:
        counts: dict = defaultdict(int)
        for _, label in samples[lo:hi]:
            counts[label] += 1
        return max(counts, key=counts.get)
    if not samples:
        return "host"
    mid = (g0 + g1) / 2
    j = bisect.bisect_left(times, mid)
    near = min((k for k in (j - 1, j) if 0 <= k < len(samples)), key=lambda k: abs(times[k] - mid))
    return samples[near][1]


def _idle_gaps(merged, runtime, window, samples):
    runtime.sort()
    starts = [r[0] for r in runtime]
    longest = max((b - a for a, b, _ in runtime), default=0.0)
    times = [t for t, _ in samples]
    sums: dict = defaultdict(float)
    for g0, g1 in reduce.gaps(merged, *window):
        best, label = 0.0, "host"
        lo = bisect.bisect_left(starts, g0 - longest)
        hi = bisect.bisect_right(starts, g1)
        for a, b, name in runtime[lo:hi]:
            cover = min(b, g1) - max(a, g0)
            if cover > best:
                best, label = cover, name
        if best < (g1 - g0) / 2:
            label = _host_label(samples, times, g0, g1)
        sums[reduce.clean_name(label)] += g1 - g0
    return reduce.top(sums)
