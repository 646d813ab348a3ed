"""The comparison that decides ``correct``: the served greedy tokens of a
sample of the window's finished requests against the plain reference.

The sample is drawn from the seed among the requests that finished in
the window, and holds the longest of them, until it has
``sample_tokens`` served tokens.  For each, the reference runs once over
the prompt and the served tokens, and reads at each served token how far
its logit lies below the reference's best at that position.  The widest
of these gaps (``max_logit_gap``) and their mean over the served tokens
(``mean_logit_gap``) are the numbers a configuration's ``limits`` may
name.  A served token outside the vocabulary, or a request with another
number of tokens than it asked for, is wrong outright.

The control is the port's own path one precision below the
configuration's bf16: its FP8 policy level (weights stored as
float8_e4m3fn, bf16 products; the routers exempt as in every policy).
It reads the same prompts and tokens in one uncached forward each: at
each position, the gap of the token it puts first.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.harness.traffic import seeded_rng
from perfbench.reference.model import (fp32_matmuls, gap_of, linear_fp32,
                                       logits_at)


def sample(finished: list, seed: int, want_tokens: int) -> list:
    """The longest finished request, then others in a seeded order, until
    the sample holds ``want_tokens`` served tokens."""
    if not finished:
        return []
    size = [s.req.prompt_len + len(s.req.tokens) for s in finished]
    first = int(np.argmax(size))
    order = [first] + [int(i) for i in seeded_rng(seed, 4).permutation(
        len(finished)) if i != first]
    out, n = [], 0
    for i in order:
        if n >= want_tokens:
            break
        out.append(finished[i])
        n += len(finished[i].req.tokens)
    return out


def readings(c: dict, weights: dict, reqs: list, device,
             control=None) -> dict:
    """``{"max_logit_gap", "mean_logit_gap"}`` of the served tokens,
    ``"wrong"`` (requests with a bad token or length) and ``"tokens"``
    (tokens compared); with ``control`` (``control(tokens, positions) ->
    logits``) also ``"control_max_logit_gap"`` and
    ``"control_mean_logit_gap"``, of the tokens it puts first."""
    vocab = int(c["vocab_size"])
    gaps, cgaps, wrong = [], [], 0
    with fp32_matmuls():
        for req in reqs:
            served = np.asarray(req.tokens, np.int64)
            if (len(served) != req.max_new_tokens or served.min() < 0
                    or served.max() >= vocab):
                wrong += 1
                continue
            seq = np.concatenate([req.prompt.astype(np.int64), served[:-1]])
            toks = torch.as_tensor(seq, device=device)
            pos = torch.arange(req.prompt_len - 1, len(seq), device=device)
            ref = logits_at(c, weights, toks, pos, linear_fp32)
            chosen = torch.as_tensor(served, device=device)
            gaps += gap_of(ref, chosen).tolist()
            if control is not None:
                low = control(toks, pos)
                cgaps += gap_of(ref, low.argmax(-1)).tolist()
                del low
            del ref
    out = {"wrong": wrong, "tokens": len(gaps), **_stats("", gaps)}
    if control is not None:
        out.update(_stats("control_", cgaps))
    return out


def _stats(prefix: str, gaps: list) -> dict:
    return {prefix + "max_logit_gap": max(gaps, default=0.0),
            prefix + "mean_logit_gap": (sum(gaps) / len(gaps)
                                        if gaps else 0.0)}
