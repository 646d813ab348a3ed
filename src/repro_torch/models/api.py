"""Model protocol: one handle over the ported model families.

``build_model(cfg, policy, device=...)`` returns an :class:`LMModel`
exposing ``init(seed)`` (randomly initialised parameters),
``empty_params()`` (uninitialised, for ``load_state_dict``), ``ctx(decode)``,
``loss(params, batch)`` (the LM cross-entropy, differentiable),
``init_cache(batch, seq_len)`` (the contiguous decode cache),
``prefill(params, batch, cache)`` and ``decode_step(params, cache,
tokens)`` over either cache layout.  The precision policy lives on the
model, not on the parameters, so one parameter set serves under several
policies.  It runs on CUDA unless the caller passes ``device="cpu"``; on
a machine without a card a CUDA model raises at construction.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.models.common import Ctx, resolve_device
from repro_torch.quant.policy import PrecisionPolicy

# MoE routers and SSM gate/Δ projections exempt from quant/prune by default
DEFAULT_EXEMPT = ["*router*", "*w_if*", "*dt_*", "*A_log*", "*gate_logit*"]


def _xent(cfg: ArchConfig, logits: torch.Tensor, labels: torch.Tensor):
    """Per-token (nll, logz) in fp32, with the padded vocab columns
    masked to -1e30 and, with ``cfg.loss_chunk``, the sequence taken
    ``loss_chunk`` tokens at a time (bounds the fp32 softmax live set)
    when it divides the sequence, as the JAX package's ``_xent``."""
    v_real = cfg.vocab_size
    v = logits.shape[-1]

    def chunk_nll(lg, lb):
        lf = lg.float()
        if v > v_real:  # mask padded vocab columns exactly
            col = torch.arange(v, device=lf.device)
            lf = torch.where(col < v_real, lf, -1e30)
        logz = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, lb[..., None].long())[..., 0]
        return logz - gold, logz

    c = cfg.loss_chunk
    s = logits.shape[1]
    if not c or s <= c or s % c:
        return chunk_nll(logits, labels)
    parts = [chunk_nll(logits[:, i:i + c], labels[:, i:i + c])
             for i in range(0, s, c)]
    return (torch.cat([p[0] for p in parts], dim=1),
            torch.cat([p[1] for p in parts], dim=1))


@dataclasses.dataclass
class LMModel:
    cfg: ArchConfig
    device: torch.device
    policy: PrecisionPolicy | None = None

    def ctx(self, decode: bool = False) -> Ctx:
        return Ctx(policy=self.policy, decode=decode)

    def init(self, seed: int = 0) -> T.LM:
        """Parameters drawn from a ``torch.Generator`` seeded with
        ``seed`` on the model's device (CPU and CUDA generators give
        different numbers for one seed)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return T.init_lm(gen, self.cfg)

    def empty_params(self) -> T.LM:
        """Uninitialised parameters on the model's device."""
        return T.LM(self.cfg, self.device)

    def loss(self, params: T.LM, batch: dict, ctx: Ctx | None = None):
        """Mean LM cross-entropy of ``batch["tokens"]`` (B, S) against
        ``batch["labels"]`` (tensors on the model's device), plus the
        1e-4 z-loss; returns (loss, {"nll", "ppl_proxy"}).  Uncached and
        differentiable — unlike :meth:`prefill` and :meth:`decode_step`,
        which run without autograd."""
        ctx = ctx or self.ctx()
        logits, _ = T.lm_apply(ctx, self.cfg, params, batch["tokens"])
        nll, logz = _xent(self.cfg, logits, batch["labels"])
        mean_nll = torch.mean(nll)
        # z-loss for stability at scale
        loss = mean_nll + 1e-4 * torch.mean(logz ** 2)
        return loss, {"nll": mean_nll,
                      "ppl_proxy": torch.exp(torch.clamp(mean_nll,
                                                         max=20.0))}

    def init_cache(self, batch: int, seq_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
        """The contiguous decode cache (:func:`transformer.init_lm_cache`)
        on the model's device."""
        return T.init_lm_cache(self.cfg, batch, seq_len, dtype, self.device)

    @torch.no_grad()
    def prefill(self, params: T.LM, batch: dict, cache: dict | None = None,
                ctx: Ctx | None = None):
        """Run ``batch["tokens"]`` (B, S) from position 0 and fill the
        contiguous ``cache`` (a fresh one of length S when omitted).
        Returns (logits, cache)."""
        ctx = ctx or self.ctx(decode=False)
        tokens = batch["tokens"]
        if cache is None:
            cache = self.init_cache(tokens.shape[0], tokens.shape[1])
        return T.lm_apply(ctx, self.cfg, params, tokens, cache=cache)

    @torch.no_grad()
    def decode_step(self, params: T.LM, cache, tokens,
                    ctx: Ctx | None = None):
        """One cached step over ``tokens`` (R, S): against a contiguous
        cache at its ``pos``, or against a paged cache — decode (S = 1)
        or, with ``prefill_lens`` in the cache, a ragged admission
        prefill."""
        ctx = ctx or self.ctx(decode=True)
        return T.lm_apply(ctx, self.cfg, params, tokens, cache=cache)


def build_model(cfg: ArchConfig, policy: PrecisionPolicy | None = None,
                device: str | torch.device | None = None) -> LMModel:
    if policy is None:
        policy = PrecisionPolicy(default="bf16", exempt=DEFAULT_EXEMPT)
    T._check_dense(cfg)
    return LMModel(cfg=cfg, device=resolve_device(device), policy=policy)
