"""The frozen reference against the program at a tiny flagship size, float32,
on the CPU: the same loss, gradients and AdamW step from the same weights."""

import ast
from pathlib import Path

import pytest
import torch

import weights
from families import flagship as fam
from reference import flagship as ref

TINY = {"vocab": 256, "dim": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
        "moe_experts": 4, "moe_topk": 2, "moe_ffn": 96, "capacity_factor": 1.25,
        "rope_theta": 10000.0, "norm_eps": 1e-6, "aux_loss_weight": 0.01,
        "z_loss_weight": 0.001, "remat": "full", "dtype": "float32"}
OPT = {"name": "adamw", "learning_rate": 3e-4, "b1": 0.9, "b2": 0.999, "eps": 1e-8,
       "weight_decay": 0.01}


def _batch(seed, b=4, s=32, vocab=256):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, vocab, (b, s + 1), generator=g)
    return ids[:, :-1], ids[:, 1:]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("capacity_factor", [1.25, 0.75, 2.0])
def test_loss_and_gradients_match_the_program(capacity_factor):
    """At 0.75 the experts drop assignments: the drop order is checked too."""
    from uccl_tpu_torch.models import flagship

    m = {**TINY, "capacity_factor": capacity_factor}
    layout = fam.layout(m)
    tokens, targets = _batch(1)

    p_prog = weights.tree(layout, 7, "cpu")
    stacked = [t.requires_grad_() for _, t in _leaves(p_prog)]
    total, _ = flagship.loss_fn(p_prog, tokens, targets, fam.program_config(m))
    g_prog = {}
    for (path, _), g in zip(_leaves(p_prog), torch.autograd.grad(total, stacked)):
        g_prog.update(weights.slices(path, g))

    work = ref._pieces(weights.tree(layout, 7, "cpu"), m)
    named = ref._named(work)
    pieces = [t.requires_grad_() for _, ts in named for t in ts]
    loss = ref.Model(m).loss(work, tokens, targets)
    it = iter(torch.autograd.grad(loss, pieces))
    g_ref = {name: torch.stack([next(it) for _ in ts]) if len(ts) > 1 else next(it)
             for name, ts in named}

    assert abs(float(total.detach()) - float(loss.detach())) <= 1e-5 * abs(float(loss.detach()))
    assert set(g_prog) == set(g_ref)
    top = max(float(g.norm()) for g in g_ref.values())
    for name, b in g_ref.items():
        assert float((g_prog[name] - b).norm()) <= 1e-4 * (float(b.norm()) + 1e-3 * top), name


def test_one_adamw_step_matches_the_program():
    m = TINY
    layout = fam.layout(m)
    batch = _batch(2)
    step, init = fam.make_step(m, OPT, "cpu")
    p_prog = weights.tree(layout, 9, "cpu")
    p_prog, _, _ = step(p_prog, init(p_prog), *batch)
    p_ref, losses, grads = ref.train(lambda: weights.tree(layout, 9, "cpu"), [batch], m, OPT,
                                     steps=1)
    assert len(losses) == 1 and set(grads) == set(weights.norms(layout, p_ref))
    p0 = weights.tree(layout, 9, "cpu")
    for path, _, _ in layout:
        a, b, c = (weights.get(t, path) for t in (p_prog, p_ref, p0))
        moved = float((b - c).norm())
        assert float((a.detach() - b).norm()) <= 1e-3 * moved + 1e-7, path


def test_the_reference_imports_torch_alone():
    tree = ast.parse((Path(ref.__file__)).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "contextlib", "math", "typing", "torch"}, names


def test_the_control_rounds_below_the_stated_precision():
    x = torch.randn(4096, dtype=torch.float64).float()
    for name, bits in (("tf32", 10), ("bfloat16", 7)):
        y = ref.ROUNDING[name][0](x)
        rel = ((y - x).abs() / x.abs()).max()
        assert 2.0 ** -(bits + 2) < rel <= 2.0 ** -(bits + 1), name
    y = ref.ROUNDING["fp8"][0](x)
    assert float(((y - x).abs() / x.abs().amax()).max()) > 2.0 ** -8
    assert ref.CONTROL == {"float32": "tf32", "bfloat16": "fp8", "float16": "fp8"}


def test_an_expert_no_token_chooses_only_decays():
    """Router columns (v, -v, 0, 0): every token's top two are one of the
    first two experts and expert 2 (the tie goes to the lower index), so
    expert 3 is never chosen; its weights take AdamW's decay alone."""
    m = TINY
    layout = fam.layout(m)

    def init():
        tree = weights.tree(layout, 4, "cpu")
        v = torch.randn(m["n_layers"], m["dim"], generator=torch.Generator().manual_seed(3))
        router = torch.zeros(m["n_layers"], m["dim"], m["moe_experts"])
        router[..., 0], router[..., 1] = v, -v
        tree["blocks"]["router"] = router
        return tree

    p_ref, losses, _ = ref.train(init, [_batch(5)], m, OPT, steps=1)
    before = init()["blocks"]["we_gate"][:, 3]
    after = p_ref["blocks"]["we_gate"][:, 3]
    decayed = before * (1 - OPT["learning_rate"] * OPT["weight_decay"])
    assert len(losses) == 1 and torch.allclose(after, decayed, rtol=1e-6, atol=1e-12)
    assert not torch.allclose(p_ref["blocks"]["we_gate"][:, 2], before, atol=1e-6)
