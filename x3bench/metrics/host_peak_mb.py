"""host_peak_mb: the peak of the process's resident memory over the
untraced window (/proc/self/statm, sampled every 10 ms by the harness's
main thread), in MB of 10^6 bytes.  One process runs every client."""


def read(run):
    return run.host_peak_bytes / 1e6
