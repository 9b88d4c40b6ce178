"""idle_unnamed_pct.<direction>: of the device's idle time in the traced
window that falls inside the program's root spans (its calls), the share
that no other span of those calls covers, on any thread, in %: idle time
the program's spans leave unnamed.  The spans are put on the trace's
clock (the profiler's Unix ns) by the program's profiler_ns.  None where
the device was never busy (the CPU) or the program records no spans."""

from x3bench import reduce, spans


def read(run):
    tr = run.trace
    prof = spans.profiling()
    if tr is None or tr.busy_s <= 0 or prof is None:
        return None
    w0, w1 = tr.window
    off = prof.profiler_ns(0)
    log = prof.spans(int(w0 * 1e9) - off)
    if log.wrapped:
        return None

    def sec(s):
        return (s.start_ns + off) * 1e-9, (s.end_ns + off) * 1e-9

    roots = {s.id: sec(s) for s in log if s.parent == 0}
    roots = {k: (a, b) for k, (a, b) in roots.items() if b > w0 and a < w1}
    if not roots:
        return None
    calls = reduce.union(roots.values())
    named = reduce.union(sec(s) for s in log if s.parent != 0 and s.call in roots)
    idle = spans.intersect(reduce.gaps(tr.device, w0, w1), calls)
    idle_s = sum(b - a for a, b in idle)
    if idle_s <= 0:
        return None
    named_s = sum(b - a for a, b in spans.intersect(idle, named))
    return 100.0 * (idle_s - named_s) / idle_s
