"""Speculative decoding for the serving engine: drafters and spec telemetry.

Port copy of ``uccl_tpu/serving/spec.py`` (host-side and jax-free there
too). Each decode pass becomes one batched ``[n_slots, k+1]`` verify window
(``inference.verify_slots`` / ``MoEServer.verify_slots``): a drafter
proposes k continuation tokens per decoding slot, and greedy acceptance
commits each slot's longest draft prefix that matches the target's own
outputs plus one target-computed token (the correction when a draft
missed, the bonus when all k hit). Acceptance only ever commits tokens the
target itself computed, so greedy output equals vanilla greedy decode on
the CPU; on a GPU the verify window runs other shapes than a one-token
decode, so there the engine is held to its own replay
(``serving.replay_alone`` with the same ``spec_k`` and drafter).

:class:`NGramDrafter` is prompt-lookup drafting: the continuation of the
context's own most recent suffix match, no second model. Custom drafters
implement :meth:`Drafter.draft` and plug into ``ServingEngine(spec_k=K,
drafter=...)``.
"""

from __future__ import annotations

import numpy as np

from uccl_tpu_torch import obs

# verification outcomes, counted per verify window:
# accepted/rejected partition the tokens the drafter actually PROPOSED
# (window pads are excluded — a pad that coincidentally matches still
# commits a correct token but is not a speculation), bonus is the one
# target-computed token every window yields. Commit truncation (EOS or
# token budget inside an accepted prefix) does not un-count an acceptance —
# these series record what verification proved, the engine's decode_tokens
# metric records what was committed.
SPEC_TOKENS = obs.counter(
    "spec_tokens_total",
    "speculative tokens by verification outcome: outcome=accepted drafts "
    "matched the target's greedy output, outcome=rejected drafts missed, "
    "outcome=bonus is the per-window target-computed token",
)
SPEC_ACCEPTED_LEN = obs.counter(
    "spec_accepted_len_total",
    "verify windows by accepted-prefix length (len=0..k): the acceptance "
    "histogram behind the spec_tokens_total rates",
)


class Drafter:
    """Proposes up to ``k`` continuation tokens for one slot's context."""

    def draft(self, context: np.ndarray, k: int) -> np.ndarray:
        """context: 1-D int32 (prompt + committed tokens). Return up to
        ``k`` proposed next tokens (int32, may be empty — the engine pads
        the verify window; a padded position that happens to match the
        target still commits a correct token, so abstaining is always
        safe)."""
        raise NotImplementedError


class NGramDrafter(Drafter):
    """Prompt-lookup drafting: propose the continuation of the context's
    own most recent suffix match.

    The longest suffix n-gram (``max_ngram`` down to ``min_ngram``) with an
    earlier occurrence in the context wins; ties between occurrences go to
    the most recent one (local context predicts local continuation best).
    Deterministic, O(context) per call, no model."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not (1 <= min_ngram <= max_ngram):
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"({min_ngram}, {max_ngram})"
            )
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def draft(self, context: np.ndarray, k: int) -> np.ndarray:
        ctx = np.asarray(context, np.int32).reshape(-1)
        n_hi = min(self.max_ngram, ctx.size - 1)
        if k < 1 or n_hi < self.min_ngram:
            return np.zeros(0, np.int32)
        for n in range(n_hi, self.min_ngram - 1, -1):
            suffix = ctx[ctx.size - n:]
            # candidate windows start at i in [0, L-n-1] — the window at
            # L-n is the suffix itself
            windows = np.lib.stride_tricks.sliding_window_view(ctx, n)
            hits = np.flatnonzero(
                (windows[: ctx.size - n] == suffix).all(axis=1)
            )
            if hits.size:
                # prefer the most recent match whose continuation has all
                # k tokens in-context: inside a repeating run the very
                # latest match sits one step back and its continuation is
                # cut short by the context end, which would cap every
                # proposal at a fraction of k
                full = hits[hits + n + k <= ctx.size]
                i = int(full[-1]) if full.size else int(hits[-1])
                return ctx[i + n: i + n + k].copy()
        return np.zeros(0, np.int32)
