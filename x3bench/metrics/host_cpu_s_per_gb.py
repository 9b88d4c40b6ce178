"""host_cpu_s_per_gb.<direction>: user and system CPU seconds of the
process (every thread; getrusage) over the untraced window, per GB
converted."""


def read(run):
    if not run.completed_bytes:
        return None
    return run.cpu_s / (run.completed_bytes / 1e9)
