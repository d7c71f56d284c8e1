"""device_idle: the share of the traced steps, in percent, in which no
kernel ran on the card: one minus the union of the kernels' intervals
(``tracekit.union_us``) over the traced window."""


def read(run):
    if not run.trace.kernels:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
