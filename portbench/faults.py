"""Faults planted under the program's train step, to show that the check
catches them: each wraps a ``train_step(params, opt_state, tokens,
targets)`` and returns the broken step.

- ``frozen``: the step returns its state unchanged;
- ``half_batch``: half of the batch is left out and the mean taken over the
  rest (half the rows, or half the sequence of a batch of one);
- ``doubled``: an answer altered where it is produced: the head is moved
  twice as far as the step moved it.

A cell at world 1 has no exchange between chips to leave out.
"""

from __future__ import annotations

import torch


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [tree] if torch.is_tensor(tree) else []


def frozen(step):
    def broken(params, opt_state, tokens, targets):
        # the state kept on the host: a copy on the card would not fit beside
        # a model that fills it
        kept = [t.detach().to("cpu", copy=True) for t in _leaves(params) + _leaves(opt_state)]
        count = opt_state["count"]
        _, _, metrics = step(params, opt_state, tokens, targets)
        with torch.no_grad():
            for t, k in zip(_leaves(params) + _leaves(opt_state), kept):
                t.copy_(k)
        opt_state["count"] = count
        return params, opt_state, metrics
    return broken


def half_batch(step):
    def broken(params, opt_state, tokens, targets):
        if tokens.shape[0] > 1:
            half = tokens.shape[0] // 2
            return step(params, opt_state, tokens[:half], targets[:half])
        half = tokens.shape[1] // 2
        return step(params, opt_state, tokens[:, :half], targets[:, :half])
    return broken


def doubled(step):
    def broken(params, opt_state, tokens, targets):
        before = params["head"].detach().clone()
        params, opt_state, metrics = step(params, opt_state, tokens, targets)
        with torch.no_grad():
            params["head"].add_(params["head"] - before)
        return params, opt_state, metrics
    return broken


FAULTS = {"frozen": frozen, "half_batch": half_batch, "doubled": doubled}
