"""device_idle_pct.<direction>: the share of the traced window in which
no kernel, copy or set ran on the card: the union of the device's
intervals over every client's work, on the trace's one clock."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
