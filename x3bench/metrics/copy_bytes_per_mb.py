"""copy_bytes_per_mb.<direction>: bytes copied between host and device
(the program's counts: `h2d_bytes` on x3.decode.launch, `d2h_bytes` on
x3.device_wait) per int16 byte decoded (the `bytes` of x3.decode.scatter),
over the untraced window's calls.  None where nothing was copied (the
CPU)."""

from x3bench import spans


def read(run):
    h2d = spans.counts(run, "x3.decode.launch") or {}
    d2h = spans.counts(run, "x3.device_wait") or {}
    out = spans.counts(run, "x3.decode.scatter") or {}
    copied = h2d.get("h2d_bytes", 0) + d2h.get("d2h_bytes", 0)
    if not copied or not out.get("bytes"):
        return None
    return copied / out["bytes"]
