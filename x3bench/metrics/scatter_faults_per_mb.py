"""scatter_faults_per_mb.<direction>: the minor page faults of the
program's x3.decode.scatter spans (their `minflt`, the thread's getrusage
count over each span) per MB (10^6 bytes) they copied into the outputs
(their `bytes`: the int16 bytes decoded), over the untraced window's
calls.  About 244 where each call's output is fresh memory in 4 KiB pages."""

from x3bench import spans


def read(run):
    got = spans.counts(run, "x3.decode.scatter")
    if not got or not got.get("bytes") or "minflt" not in got:
        return None
    return got["minflt"] / (got["bytes"] / 1e6)
