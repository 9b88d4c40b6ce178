"""scatter_wait_ms.<direction>: ms a call in the program's x3.scatter_wait
spans (the caller blocked on decode_streams' scatter worker: a copy queued
while the last is pending, and the wait for the last copy), self time,
over the untraced window's calls (x3bench/spans.py).  None for a program
without the worker, or where no call had two or more batches."""

from x3bench import spans


def read(run):
    return spans.ms_a_call(run, "x3.scatter_wait")
