"""Plain PyTorch reference of the flagship family's training step.

The model, as the configuration file states it: token embedding; per layer
RMSNorm, Q/K/V projections, rotary embedding (split halves, frequencies
``theta ** (-2i / d)``), causal grouped-query softmax attention (query head
``j`` reads KV head ``j // (H / Hkv)``), output projection and residual;
RMSNorm, a softmax router over the experts, the top-k gates renormalised to
sum to one, a per-expert capacity ``int(capacity_factor * T * k / E)`` over
the step's ``T`` tokens, filled in order of the k-th choice first and then of
the token (an assignment past the capacity is dropped and adds nothing),
SwiGLU experts, the gate-weighted sum and residual; final RMSNorm and an
untied head. The loss is the mean next-token cross-entropy plus, averaged
over the layers, ``aux_loss_weight`` times the load-balance loss
``E / k * sum_e mean_t(p_te) * mean_t(#choices of e by t)`` and
``z_loss_weight`` times the mean squared log-sum-exp of the router logits.
AdamW as ``optax.adamw``: bias-corrected moments, ``eps`` outside the
square root, the decay ``weight_decay * p`` added to the update.

Everything runs in float32 with TF32 off, each expert on the tokens it
kept, with no kernel of the program and no capacity padding. A control
(``control=<name>``, one of :data:`CONTROLS`) takes one part of the step one
precision below what the configuration states:

- ``products``: the operands of every product that the configuration runs
  in its activation dtype (projections, attention, the expert GEMMs), and
  their gradients, at the precision one below it: fp8 for bfloat16 (e4m3,
  one scale a tensor; gradients e5m2), TF32 for float32;
- ``head_router``: the float32 head and router products' operands and
  gradients in TF32;
- ``moments``: AdamW's float32 moments held in bfloat16;
- ``params``: the float32 parameters held in bfloat16 (the drawn weights
  and every updated value rounded to it).

Imports torch only.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

SCORES = 2**29  # float32 attention scores held at once (2 GiB)
BLOCK_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "router", "we_gate", "we_up", "we_down")


def _scaled_fp8(x: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    top = torch.finfo(fmt).max
    scale = top / x.detach().abs().amax().float().clamp_min(1e-30)
    return (x.float() * scale).to(fmt).float() / scale


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest, ties away."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


ROUNDING = {  # (forward operand, its gradient)
    "tf32": (_tf32, _tf32),
    "bfloat16": (lambda x: x.to(torch.bfloat16).float(), lambda g: g.to(torch.bfloat16).float()),
    "fp8": (lambda x: _scaled_fp8(x, torch.float8_e4m3fn),
            lambda g: _scaled_fp8(g, torch.float8_e5m2)),
}
# the products' control of each activation dtype: the precision one below it
CONTROL = {"float32": "tf32", "bfloat16": "fp8", "float16": "fp8"}
CONTROLS = ("products", "head_router", "moments", "params")


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, precision):
        ctx.precision = precision
        return ROUNDING[precision][0](x)

    @staticmethod
    def backward(ctx, g):
        return ROUNDING[ctx.precision][1](g), None


class Model:
    """The forward pass and loss at widths ``m`` (the configuration file's
    ``model``)."""

    def __init__(self, m: Dict, precision: str = "float32", f32_precision: str = "float32"):
        self.m = m
        self.precision = precision
        self.f32_precision = f32_precision

    def op(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product in the activation dtype."""
        return x if self.precision == "float32" else _Round.apply(x, self.precision)

    def f32_op(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of the head's or the router's float32 product."""
        return x if self.f32_precision == "float32" else _Round.apply(x, self.f32_precision)

    def rms(self, x, w):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.m["norm_eps"]) * w

    def rope(self, x):  # [B, S, H, D]
        s, d = x.shape[1], x.shape[-1]
        half = d // 2
        inv = self.m["rope_theta"] ** (-torch.arange(half, dtype=torch.float32,
                                                      device=x.device) * 2.0 / d)
        ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
        cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
        a, b = x[..., :half], x[..., half:]
        return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)

    def attention(self, h, wq, wk, wv, wo):
        m = self.m
        bsz, s, _ = h.shape
        d, nh, nkv = m["head_dim"], m["n_heads"], m["n_kv_heads"]
        hq = self.op(h)
        q = (hq @ self.op(wq)).view(bsz, s, nh, d)
        k = (hq @ self.op(wk)).view(bsz, s, nkv, d)
        v = (hq @ self.op(wv)).view(bsz, s, nkv, d)
        q, k = self.rope(q), self.rope(k)
        group = torch.arange(nh, device=h.device) // (nh // nkv)
        q = q.permute(0, 2, 1, 3)  # [B, H, S, D]
        k = k[:, :, group].permute(0, 2, 3, 1)  # [B, H, D, S]
        v = v[:, :, group].permute(0, 2, 1, 3)  # [B, H, S, D]
        future = torch.ones(s, s, dtype=torch.bool, device=h.device).triu(1)
        rows = max(1, SCORES // (nh * s * s))  # batch rows a block of scores
        parts = []
        for i in range(0, bsz, rows):
            scores = (self.op(q[i:i + rows]) @ self.op(k[i:i + rows])) / math.sqrt(d)
            p = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
            del scores
            parts.append(self.op(p) @ self.op(v[i:i + rows]))
        out = torch.cat(parts).permute(0, 2, 1, 3).reshape(bsz, s, nh * d)
        return self.op(out) @ self.op(wo)

    def moe(self, x, router, w_gate, w_up, w_down):
        """x [T, H] -> (out [T, H], load-balance loss, z loss)."""
        m = self.m
        t, e, k = x.shape[0], m["moe_experts"], m["moe_topk"]
        logits = self.f32_op(x) @ self.f32_op(router)  # float32, as stated
        probs = torch.softmax(logits, dim=-1)
        top, choice = torch.sort(probs, dim=-1, descending=True, stable=True)
        top, choice = top[:, :k], choice[:, :k]
        gate = top / top.sum(-1, keepdim=True).clamp_min(1e-9)
        picks = F.one_hot(choice, e).float()  # [T, k, E]
        balance = (probs.mean(0) * picks.sum(1).mean(0)).sum() * (e / k)
        z = torch.logsumexp(logits, dim=-1).pow(2).mean()

        capacity = max(1, int(m["capacity_factor"] * t * k / e))
        order = picks.transpose(0, 1).reshape(k * t, e)  # k-th choices first, then tokens
        place = (order.cumsum(0) * order).sum(-1).reshape(k, t).t() - 1  # [T, k] queue slot
        kept = place < capacity
        out = torch.zeros_like(x)
        for ex in range(e):
            tok, kth = torch.nonzero((choice == ex) & kept, as_tuple=True)
            if tok.numel() == 0:
                continue
            xe = self.op(x[tok])
            hid = F.silu(xe @ self.op(w_gate[ex])) * (xe @ self.op(w_up[ex]))
            y = self.op(hid) @ self.op(w_down[ex])
            out = out.index_add(0, tok, y * gate[tok, kth][:, None])
        return out, balance, z

    def layer(self, x, ln1, ln2, wq, wk, wv, wo, router, w_gate, w_up, w_down):
        x = x + self.attention(self.rms(x, ln1), wq, wk, wv, wo)
        bsz, s, h = x.shape
        out, balance, z = self.moe(self.rms(x, ln2).reshape(bsz * s, h), router, w_gate, w_up,
                                   w_down)
        aux = self.m["aux_loss_weight"] * balance + self.m["z_loss_weight"] * z
        return x + out.reshape(bsz, s, h), aux

    def loss(self, params: Dict, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """The total loss of one batch; each layer recomputed in backward.
        ``params["blocks"]`` is a list of layers, each expert weight a list
        of experts (:func:`_pieces`)."""
        x = params["embed"][tokens]
        aux = x.new_zeros(())
        for lp in params["blocks"]:
            x, a = checkpoint(self.layer, x, *(lp[key] for key in BLOCK_KEYS),
                              use_reentrant=False)
            aux = aux + a
        y = self.rms(x, params["final_norm"])
        logits = (self.f32_op(y) @ self.f32_op(params["head"])).reshape(-1, self.m["vocab"])
        ce = F.cross_entropy(logits, targets.reshape(-1))
        return ce + aux / self.m["n_layers"]


@contextlib.contextmanager
def full_float32():
    """float32 products in float32: TF32 off for the block, then restored."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


EXPERT_KEYS = ("we_gate", "we_up", "we_down")


def _pieces(tree: Dict, m: Dict) -> Dict:
    """The leaves the reference trains: each stacked block leaf split into
    one tensor a layer, and the experts' weights into one a expert, so that
    autograd never builds a stacked leaf's full-size gradient for each slice
    it reads. Consumes ``tree``'s tensors one at a time."""
    work = {k: tree.pop(k) for k in ("embed", "final_norm", "head")}
    blocks = tree.pop("blocks")
    work["blocks"] = [{} for _ in range(m["n_layers"])]
    for key in BLOCK_KEYS:
        stacked = blocks.pop(key)
        for i, layer in enumerate(work["blocks"]):
            if key in EXPERT_KEYS:
                layer[key] = [w.clone() for w in stacked[i]]
            else:
                layer[key] = stacked[i].clone()
        del stacked
    return work


def _stacked(work: Dict) -> Dict:
    """:func:`_pieces` undone: the tree in the program's layout."""
    layers, blocks = work.pop("blocks"), {}
    for key in BLOCK_KEYS:
        parts = [torch.stack(lp.pop(key)) if key in EXPERT_KEYS else lp.pop(key)
                 for lp in layers]
        blocks[key] = torch.stack(parts)
        del parts
    return {"embed": work.pop("embed"), "blocks": blocks, "final_norm": work.pop("final_norm"),
            "head": work.pop("head")}


def _named(work: Dict) -> List[Tuple[str, List[torch.Tensor]]]:
    """Each counted leaf's name (``embed``, ``blocks.<key>.<layer>``, ...)
    and the pieces it is made of, in a fixed order."""
    out = [(k, [work[k]]) for k in ("embed", "final_norm", "head")]
    for key in BLOCK_KEYS:
        for i, lp in enumerate(work["blocks"]):
            out.append((f"blocks.{key}.{i}", list(lp[key]) if key in EXPERT_KEYS else [lp[key]]))
    return out


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def adamw(params: Sequence[torch.Tensor], grads: Iterable[torch.Tensor], mu, nu, count: int,
          opt: Dict, *, held: str = "") -> None:
    """One AdamW step in place (``count`` is the step's number, from 1).
    ``held``: ``moments`` or ``params`` keeps those in bfloat16."""
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    lr, wd = opt["learning_rate"], opt["weight_decay"]
    bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    with torch.no_grad():
        for p, g, m1, m2 in zip(params, grads, mu, nu):
            m1.mul_(b1).add_(g, alpha=1.0 - b1)
            m2.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            if held == "moments":
                m1.copy_(_bf16(m1))
                m2.copy_(_bf16(m2))
            step = (m1 / bc1).div_((m2 / bc2).sqrt_().add_(eps))
            p.sub_(step.add_(p, alpha=wd), alpha=lr)
            if held == "params":
                p.copy_(_bf16(p))


def train(init: Callable[[], Dict], batches, m: Dict, opt: Dict, *, control: str = "",
          steps: int = 3) -> Tuple[Dict, List[float], Dict[str, float]]:
    """``steps`` AdamW steps from the weights ``init()`` returns, one batch a
    step. Returns the trained tree (in the program's layout), each step's
    loss and the norm of each counted leaf's step-1 gradient. ``control``:
    one of :data:`CONTROLS`, or empty for the reference itself."""
    if control and control not in CONTROLS:
        raise ValueError(f"unknown control {control!r}; want one of {CONTROLS}")
    model = Model(m, CONTROL[m["dtype"]] if control == "products" else "float32",
                  "tf32" if control == "head_router" else "float32")
    held = control if control in ("moments", "params") else ""
    work = _pieces(init(), m)
    named = _named(work)
    leaves = [t.requires_grad_() for _, ts in named for t in ts]
    if held == "params":
        with torch.no_grad():
            for t in leaves:
                t.copy_(_bf16(t))
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    losses, grad_norms = [], {}
    with full_float32():
        for i, (tokens, targets) in enumerate(batches[:steps]):
            loss = model.loss(work, tokens, targets)
            # an expert no token chose is unused: its gradient is zero
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
            losses.append(float(loss.detach()))
            if i == 0:
                it = iter(grads)
                for name, ts in named:
                    sq = sum(float(torch.linalg.vector_norm(next(it))) ** 2 for _ in ts)
                    grad_norms[name] = math.sqrt(sq)
            adamw(leaves, grads, mu, nu, i + 1, opt, held=held)
            del grads, loss
    del mu, nu, named
    for t in leaves:
        t.requires_grad_(False)
    del leaves
    return _stacked(work), losses, grad_norms
