"""The program's own spans and counters (x3_tpu_torch.utils.profiling),
as the per-layer metrics that name a span read them.

The program records every span in memory whether or not anything traces
it; a span carries its call's id (that of the call's outermost span, the
root), its parent's id, its thread and its counts, on the clock of
time.perf_counter_ns, which is the clock of the harness's window
(`run.start`, `run.end`).  A program that records no spans (one older than
them) gives nothing here, and every reader then gives None."""

from __future__ import annotations

from collections import defaultdict

from . import reduce

ROOT = "x3.decode_streams"  # the root span of a call of the decode entry


def profiling():
    """The program's profiling module if it records spans, else None."""
    try:
        from x3_tpu_torch.utils import profiling as prof
    except ImportError:
        return None
    return prof if all(hasattr(prof, f) for f in ("spans", "counters", "profiler_ns")) else None


def window_calls(run, root: str = ROOT):
    """(roots, members): the root spans named `root` that lie inside the
    untraced window [run.start, run.end], and every other span of their
    calls, on any thread.  None where the program records no spans, where
    the ring overwrote spans that ended inside the window, or where no
    such root is held.  Kept on the run for the next reader."""
    key = ("_x3bench_window_calls", root)
    if key not in run.__dict__:
        run.__dict__[key] = _window_calls(run, root)
    return run.__dict__[key]


def _window_calls(run, root):
    prof = profiling()
    if prof is None:
        return None
    lo, hi = int(run.start * 1e9), int(run.end * 1e9)
    log = prof.spans(lo)
    if log.wrapped:
        return None
    roots = {s.id: s for s in log if s.parent == 0 and s.name == root and s.start_ns >= lo and s.end_ns <= hi}
    if not roots:
        return None
    return list(roots.values()), [s for s in log if s.call in roots and s.parent != 0]


def self_ns(span, children) -> int:
    """The span's duration less the part of it that its children cover."""
    inside = reduce.union((max(c.start_ns, span.start_ns), min(c.end_ns, span.end_ns)) for c in children)
    return span.end_ns - span.start_ns - sum(b - a for a, b in inside if b > a)


def ms_a_call(run, name: str):
    """The self time of the spans named `name` in the window's calls, in
    ms a call (summed over the calls, over the number of calls)."""
    got = window_calls(run)
    if got is None:
        return None
    roots, members = got
    kids = defaultdict(list)
    for s in members:
        kids[s.parent].append(s)
    named = [s for s in members if s.name == name]
    if not named:
        return None
    return sum(self_ns(s, kids[s.id]) for s in named) / len(roots) / 1e6


def counts(run, name: str) -> dict | None:
    """Each count summed over the spans named `name` in the window's calls
    ({} for spans without counts); None where no such span is held."""
    got = window_calls(run)
    if got is None:
        return None
    named = [s for s in got[1] if s.name == name]
    if not named:
        return None
    out: dict = defaultdict(int)
    for s in named:
        for k, v in s.counts.items():
            out[k] += v
    return dict(out)


def intersect(a, b) -> list[tuple[float, float]]:
    """The intersection of two lists of sorted disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out
