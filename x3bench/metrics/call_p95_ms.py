"""call_p95_ms.<direction>: the 95th percentile of the calls' wall times,
the harness's span around each call of the entry, over every client's
calls in the untraced window."""

from x3bench import reduce


def read(run):
    if not run.calls:
        return None
    return reduce.p95([1e3 * (c.end - c.start) for c in run.calls if c.ok])
