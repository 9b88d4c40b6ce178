"""out_reuse_pct.<direction>: the share of the output bytes of the
untraced window's calls that the program served from recycled pages: the
`reused_bytes` of its x3.decode.scatter spans (counted on the outputs'
allocation, utils.outpool) over their `bytes` (the int16 bytes the calls
copied into their outputs, each output sample once), in %.  None for a
program that counts no `reused_bytes`."""

from x3bench import spans


def read(run):
    got = spans.counts(run, "x3.decode.scatter")
    if not got or not got.get("bytes") or "reused_bytes" not in got:
        return None
    return 100 * got["reused_bytes"] / got["bytes"]
