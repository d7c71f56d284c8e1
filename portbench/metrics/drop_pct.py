"""drop_pct: the share of the MoE router's choices dropped at capacity over
the traced steps, in percent: 100 (1 - kept / choices), from the program's
counter ``ep.ops.MOE_COUNTS`` (counted once a forward while the profiler
runs). None from a program without the counter."""


def read(run):
    try:
        from uccl_tpu_torch.ep.ops import MOE_COUNTS
    except ImportError:
        return None
    return MOE_COUNTS.read().get("drop_pct")
