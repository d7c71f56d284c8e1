"""gemm_ms: device ms a step in matrix-product kernels (``tracekit.
kernel_class`` class ``gemm``: cuBLAS and CUTLASS), the block projections,
router, expert GEMMs and head, forward, recompute and backward."""


def read(run):
    spent = run.trace.seconds_in_classes(("gemm",))
    return 1e3 * spent / run.trace_steps if spent > 0 else None
