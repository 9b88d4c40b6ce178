"""<direction>_mbs: int16 MB converted by all clients over the whole
window."""

from x3bench import reduce


def read(run):
    return reduce.window_rate(run.completed_bytes, run.start, run.end)
