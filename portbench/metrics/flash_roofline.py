"""flash_roofline: the bf16 flash kernels' (B1-B3) share of their roofline,
in percent.

For every launch of the traced steps (the program's ``launch_counts``), the
least time its shapes allow (``flops.flash_least_s``: causal FLOPs at the
bf16 peak or bytes at the HBM peak, whichever is larger), summed, over the
device time of the kernels of class ``flash`` in the trace.
"""

from flops import FLASH_MATMULS, flash_least_s


def read(run):
    counts = run.flash_launches
    launched = sum(counts.get(k, 0) for k in FLASH_MATMULS)
    if run.peaks is None or launched == 0 or launched != sum(counts.values()):
        return None  # no bf16 launch, or f32 ones this reader has no bound for
    shape = run.family.attention_shape(run.model, run.mix)
    least = sum(n * flash_least_s(k, **shape, itemsize=2, flops_peak=run.peaks["bfloat16"],
                                  hbm=run.peaks["hbm"])
                for k, n in counts.items() if n)
    spent = run.trace.seconds_in_classes(("flash",))
    return 100.0 * least / spent if spent > 0 else None
