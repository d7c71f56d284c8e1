"""The flagship family: the program under test is ``uccl_tpu_torch.models.
flagship.make_train_step(cfg, device)``'s ``train_step``, at world 1.

A configuration file of this family gives ``model`` (the fields of
``FlagshipConfig`` it sets, ``dtype`` by name) and ``optimizer`` (AdamW's
learning rate and constants, and ``state_dtype``, the dtype it states for
parameters and optimizer state). The parameter layout and the init scales are
the program's (``flagship.param_shapes``, ``flagship.init_params``), written
out here so that the weights do not depend on the program's code.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch

from flops import model_flops_per_token as flops_per_token  # noqa: F401  (read by mfu)

# What the program's train step fixes: optax.adamw's constants (the
# learning rate is the step's argument).
PROGRAM_ADAMW = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "weight_decay": 0.01}


def layout(m: Dict) -> List:
    """(path, shape, scale) of every leaf, in the program's tree order."""
    h, n_l, e, f = m["dim"], m["n_layers"], m["moe_experts"], m["moe_ffn"]
    qd, kvd = m["n_heads"] * m["head_dim"], m["n_kv_heads"] * m["head_dim"]
    s_in = 1.0 / math.sqrt(h)
    blocks = [
        ("ln1", (n_l, h), None), ("ln2", (n_l, h), None),
        ("wq", (n_l, h, qd), s_in), ("wk", (n_l, h, kvd), s_in), ("wv", (n_l, h, kvd), s_in),
        ("wo", (n_l, qd, h), 1.0 / math.sqrt(qd)),
        ("router", (n_l, h, e), s_in),
        ("we_gate", (n_l, e, h, f), s_in), ("we_up", (n_l, e, h, f), s_in),
        ("we_down", (n_l, e, f, h), 1.0 / math.sqrt(f)),
    ]
    return ([(("embed",), (m["vocab"], h), 0.02)]
            + [(("blocks", k), shape, scale) for k, shape, scale in blocks]
            + [(("final_norm",), (h,), None), (("head",), (h, m["vocab"]), s_in)])


def program_config(m: Dict):
    from uccl_tpu_torch.models import flagship

    fields = {f.name for f in dataclasses.fields(flagship.FlagshipConfig)}
    unknown = set(m) - fields
    if unknown:
        raise ValueError(f"model keys the program does not have: {sorted(unknown)}")
    return flagship.FlagshipConfig(**{**m, "dtype": getattr(torch, m["dtype"])})


def make_step(m: Dict, opt: Dict, device):
    """(train_step, init_optimizer) of the program; raises if the
    configuration asks for an optimizer the program does not run."""
    from uccl_tpu_torch.models import flagship

    for key, val in PROGRAM_ADAMW.items():
        if opt[key] != val:
            raise ValueError(f"the program's AdamW fixes {key}={val}; the configuration "
                             f"states {opt[key]}")
    return flagship.make_train_step(program_config(m), device, opt["learning_rate"])


def first_moment(opt_state) -> Dict:
    """The optimizer's first moment, as a tree shaped like the parameters."""
    return opt_state["mu"]


def flash_launches() -> Dict[str, int]:
    """The program's counter of flash kernel launches."""
    from uccl_tpu_torch.ops import flash_attention

    return dict(flash_attention.launch_counts)


def attention_shape(m: Dict, mix: Dict) -> Dict:
    """What one flash launch of a step sees at world 1 (cp = 1): q ``[B, S, H,
    D]``, k and v ``[B, S, Hkv, D]``, causal."""
    return {"b": mix["batch"], "s": mix["seq"], "h": m["n_heads"], "hkv": m["n_kv_heads"],
            "d": m["head_dim"], "causal": True}
