"""expert_fill: the share of the expert slots the MoE GEMMs compute that
hold a token, over the traced steps, in percent: 100 kept / (E x C), from
the program's counter ``ep.ops.MOE_COUNTS`` (counted once a forward while
the profiler runs). None from a program without the counter."""


def read(run):
    try:
        from uccl_tpu_torch.ep.ops import MOE_COUNTS
    except ImportError:
        return None
    return MOE_COUNTS.read().get("expert_fill")
