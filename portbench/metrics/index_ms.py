"""index_ms: device ms a step in index, gather, scatter and sort kernels
(``tracekit.kernel_class`` classes ``index`` and ``sort``): the MoE layer's
routing, slot plan, row gathers and the combine's gathers, forward and
backward."""


def read(run):
    spent = run.trace.seconds_in_classes(("index", "sort"))
    return 1e3 * spent / run.trace_steps if spent > 0 else None
