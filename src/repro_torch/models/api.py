"""Model protocol: one handle over the ported model families.

``build_model(cfg, device=...)`` returns an :class:`LMModel` exposing
``init(seed)`` (randomly initialised parameters), ``empty_params()``
(uninitialised, for ``load_state_dict``), ``ctx(decode)`` and
``decode_step(params, cache, tokens)``.  It runs on CUDA unless the
caller passes ``device="cpu"``; on a machine without a card a CUDA
model raises at construction.
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

    @torch.no_grad()
    def decode_step(self, params: T.LM, cache, tokens,
                    ctx: Ctx | None = None):
        """One cached step over ``tokens`` (R, S) against a paged cache:
        decode (S = 1) or, with ``prefill_lens`` in the cache, a ragged
        admission prefill."""
        ctx = ctx or self.ctx(decode=True)
        return T.lm_apply(ctx, self.cfg, params, tokens, cache=cache)


def build_model(cfg: ArchConfig, policy: PrecisionPolicy | None = None,
                device: str | torch.device | None = None) -> LMModel:
    if policy is None:
        policy = PrecisionPolicy(default="bf16", exempt=DEFAULT_EXEMPT)
    T._check_dense(cfg)
    return LMModel(cfg=cfg, device=resolve_device(device), policy=policy)
