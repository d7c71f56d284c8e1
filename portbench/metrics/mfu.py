"""mfu: the whole train step's share of the card's peak, in percent.

Model FLOPs (``flops.model_flops_per_token``: the top-k active experts, no
capacity padding, no remat recompute) times the tokens of every step of the
untraced window, over the window's host-clock length and the card's dense
peak in the configuration's activation dtype.
"""


def read(run):
    if run.peaks is None or run.model["dtype"] not in run.peaks:
        return None
    tokens = run.mix["batch"] * run.mix["seq"] * run.steps
    flops = run.family.flops_per_token(run.model, run.mix["seq"]) * tokens
    return 100.0 * flops / run.window_s / run.peaks[run.model["dtype"]]
