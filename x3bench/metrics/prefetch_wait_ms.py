"""prefetch_wait_ms.<direction>: ms a call that the caller spends blocked
on the read-ahead queue (the program's x3.prefetch_wait spans), over the
untraced window's calls (x3bench/spans.py)."""

from x3bench import spans


def read(run):
    return spans.ms_a_call(run, "x3.prefetch_wait")
