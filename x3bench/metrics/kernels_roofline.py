"""<direction>_kernels_roofline: the least time the traced calls' work
takes at the HBM's 3.35 TB/s over the union of every kernel's device time
in the trace, in %.  The work is counted from the inputs, not from the
program's tensors: each call's int16 samples and its payload bytes (as the
reference's archives hold them), each once: read and written for a
decode, written and read for an encode."""

from x3bench import reduce


def read(run):
    if run.trace is None or run.trace.kernel_s <= 0:
        return None
    work = sum(run.bytes_per_call[c.client] + run.payload_bytes_per_call[c.client]
               for c in run.traced_calls if c.ok)
    if not work:
        return None
    return 100.0 * (work / reduce.HBM_BYTES_PER_S) / run.trace.kernel_s
