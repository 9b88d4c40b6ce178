"""kernel_build_s: seconds the process has spent in the program's
x3.kernels.build spans (ops._build.load: nvcc where a checkout has no
library yet, then the library's load), from the program's running totals,
which keep every span since the process started.  All of it falls in
set-up: a checkout's first run builds, later runs only load.  None where
no kernel was loaded (the CPU)."""

from x3bench import spans


def read(run):
    prof = spans.profiling()
    if prof is None:
        return None
    tot = prof.counters().get("x3.kernels.build")
    return tot["ns"] / 1e9 if tot else None
