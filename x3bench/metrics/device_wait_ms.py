"""device_wait_ms.<direction>: ms a call that the host spends blocked on
the event behind a read-back (the program's x3.device_wait spans), over
the untraced window's calls (x3bench/spans.py)."""

from x3bench import spans


def read(run):
    return spans.ms_a_call(run, "x3.device_wait")
