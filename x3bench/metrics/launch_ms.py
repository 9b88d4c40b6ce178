"""launch_ms.<direction>: ms a call in the program's x3.decode.launch
spans (the upload, the word gather, K3 + K1 and the compaction enqueued,
up to the read-back's wait), self time, over the untraced window's calls
(x3bench/spans.py)."""

from x3bench import spans


def read(run):
    return spans.ms_a_call(run, "x3.decode.launch")
