"""index_ms.<direction>: ms a call in the program's x3.decode.index span
(every archive's header and frame index, multifile.decode_streams), self
time, over the untraced window's calls (x3bench/spans.py)."""

from x3bench import spans


def read(run):
    return spans.ms_a_call(run, "x3.decode.index")
