"""Model protocol: one handle over the ported model families (the
decoder-only ones: dense and MoE with GQA or MLA attention, xLSTM's SSM
and zamba2's hybrid; and the encoder-decoder family, whisper).

``build_model(cfg, policy, device=...)`` returns an :class:`LMModel`
exposing ``init(seed)`` (randomly initialised parameters),
``empty_params()`` (uninitialised, for ``load_state_dict``), ``ctx(decode)``,
``loss(params, batch)`` (the LM cross-entropy, differentiable),
``init_cache(batch, seq_len)`` (the contiguous decode cache),
``prefill(params, batch, cache)`` and ``decode_step(params, cache,
tokens)`` over either cache layout.  An enc-dec model's ``batch`` also
carries ``frames`` (B, n_frames, d_model), the precomputed conv-frontend
embeddings, for ``loss`` and ``prefill``; its prefill encodes them once
into the cache's cross K/V.  The precision policy lives on the
model, not on the parameters, so one parameter set serves under several
policies.  It runs on CUDA unless the caller passes ``device="cpu"``; on
a machine without a card a CUDA model raises at construction.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import transformer as T
from repro_torch.models.common import Ctx, resolve_device
from repro_torch.parallel.sharding import (axis_sizes, batch_placements,
                                           is_dtensor)
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


def _mesh_xent(cfg: ArchConfig, mesh, logits, labels):
    """:func:`_xent` of DTensor logits: gathered over the vocabulary (the
    mesh axes other than batch's), then each rank's batch rows alone
    (``local_map``), so that every row's sum is the unsharded one's."""
    from torch.distributed.tensor.experimental import local_map
    rows = batch_placements(mesh, rows=logits.shape[0])
    logits = logits.redistribute(mesh, rows)
    labels = labels.redistribute(mesh, rows)
    return local_map(functools.partial(_xent, cfg), out_placements=(rows,
                     rows), in_placements=(rows, rows), device_mesh=mesh)(
        logits, labels)


@dataclasses.dataclass
class LMModel:
    cfg: ArchConfig
    device: torch.device
    policy: PrecisionPolicy | None = None
    mesh: Any = None
    fsdp_params: bool = False

    def ctx(self, decode: bool = False) -> Ctx:
        return Ctx(policy=self.policy, decode=decode, mesh=self.mesh)

    # ----------------------------------------------------- dry-run surface
    @functools.cached_property
    def _abstract(self):
        """The model on the ``meta`` device: shapes and dtypes, no
        allocation."""
        return (T.EncDec if self.cfg.enc_dec else T.LM)(self.cfg, "meta")

    def abstract_params(self) -> T.LM | T.EncDec:
        return self._abstract

    def param_axes(self) -> dict:
        """The JAX package's logical-axes tree of the parameters, in its
        stacked layout (``param_tree()``'s keys; block leaves lead with
        ``"layers"``)."""
        return T.module_axes(self._abstract)

    def abstract_cache(self, batch: int, seq_len: int,
                       dtype: torch.dtype = torch.bfloat16):
        """(the contiguous cache on the ``meta`` device, its axes)."""
        cfg = self.cfg
        if cfg.enc_dec:
            cache = T.init_encdec_cache(self.ctx(), cfg, None, batch, seq_len,
                                        dtype=dtype, device="meta")
        else:
            cache = T.init_lm_cache(cfg, batch, seq_len, dtype, "meta")
        return cache, T.cache_axes(cfg)

    def cache_axes(self, batch: int, seq_len: int) -> dict:
        return T.cache_axes(self.cfg)

    def input_specs(self, shape: ShapeSpec) -> dict[str, torch.Tensor]:
        """``meta`` stand-ins for every model input of this shape (the
        dry-run contract; no allocation), as the reference's
        ``ShapeDtypeStruct`` stand-ins: int32 tokens and labels (B, S) — decode
        (B, 1) tokens alone — and an enc-dec model's bf16 frames."""
        def spec(shp, dtype=torch.int32):
            return torch.empty(shp, dtype=dtype, device="meta")

        b = shape.global_batch
        if shape.is_decode:
            return {"tokens": spec((b, 1))}
        s = shape.seq_len
        specs = {"tokens": spec((b, s)), "labels": spec((b, s))}
        if self.cfg.enc_dec:
            specs["frames"] = spec((b, self.cfg.n_frames, self.cfg.d_model),
                                   torch.bfloat16)
        if shape.kind == "prefill":
            specs.pop("labels")
        return specs

    def init(self, seed: int = 0) -> T.LM | T.EncDec:
        """Parameters drawn from a ``torch.Generator`` seeded with
        ``seed`` on the model's device (CPU and CUDA generators give
        different numbers for one seed)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        if self.cfg.enc_dec:
            return T.init_encdec(gen, self.cfg)
        return T.init_lm(gen, self.cfg)

    def empty_params(self) -> T.LM | T.EncDec:
        """Uninitialised parameters on the model's device."""
        if self.cfg.enc_dec:
            return T.EncDec(self.cfg, self.device)
        return T.LM(self.cfg, self.device)

    def loss(self, params: T.LM, batch: dict, ctx: Ctx | None = None):
        """Mean LM cross-entropy of ``batch["tokens"]`` (B, S) against
        ``batch["labels"]`` (tensors on the model's device), plus the
        1e-4 z-loss; returns (loss, {"nll", "ppl_proxy"}).  No MoE
        auxiliary loss is added: the JAX package's ``loss`` adds none
        either (its docstring's "+ 0.01 · MoE aux loss" is not in its
        code); :func:`layers.moe_aux_loss` computes it.  Uncached and
        differentiable — unlike :meth:`prefill` and :meth:`decode_step`,
        which run without autograd."""
        ctx = ctx or self.ctx()
        if self.cfg.enc_dec:
            enc_out = T.encdec_encode(ctx, self.cfg, params, batch["frames"])
            logits, _ = T.encdec_decode(ctx, self.cfg, params,
                                        batch["tokens"], enc_out=enc_out)
        else:
            logits, _ = T.lm_apply(ctx, self.cfg, params, batch["tokens"])
        if is_dtensor(logits):
            nll, logz = _mesh_xent(self.cfg, self.mesh, logits,
                                   batch["labels"])
        else:
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
        on the model's device; ``dtype`` reaches the attention caches,
        never the SSM families' recurrent states (fp32).  An enc-dec
        model's is :meth:`_encdec_empty_cache`."""
        if self.cfg.enc_dec:
            return self._encdec_empty_cache(batch, seq_len, dtype)
        return T.init_lm_cache(self.cfg, batch, seq_len, dtype, self.device)

    def _encdec_empty_cache(self, batch: int, seq_len: int,
                            dtype: torch.dtype) -> dict:
        """The decoder's self cache and zero cross K/V
        (:func:`transformer.init_encdec_cache` without frames)."""
        return T.init_encdec_cache(self.ctx(), self.cfg, None, batch,
                                   seq_len, dtype=dtype, device=self.device)

    @torch.no_grad()
    def prefill(self, params: T.LM, batch: dict, cache: dict | None = None,
                ctx: Ctx | None = None):
        """Run ``batch["tokens"]`` (B, S) from position 0 and fill the
        contiguous ``cache`` (a fresh one of length S when omitted).
        Returns (logits, cache).

        Enc-dec: the encoder runs over ``batch["frames"]`` once and its
        cross K/V are written into the cache (4,096 slots and bf16 when
        omitted, as the JAX package's) in place; the decoder then fills
        the self cache from position 0."""
        ctx = ctx or self.ctx(decode=False)
        tokens = batch["tokens"]
        if self.cfg.enc_dec:
            if cache is None:
                cache = self.init_cache(tokens.shape[0], 4096)
            T.encode_cross_kv(ctx, self.cfg, params, batch["frames"], cache)
            return T.encdec_decode(ctx, self.cfg, params, tokens,
                                   cache=cache)
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
        if self.cfg.enc_dec:
            return T.encdec_decode(ctx, self.cfg, params, tokens,
                                   cache=cache)
        return T.lm_apply(ctx, self.cfg, params, tokens, cache=cache)


# the families whose forward runs on DTensors
MESH_FAMILIES = ("dense", "vlm")
# the slice of ROADMAP Queue 1 that shards the experts over ``model``
EXPERT_PARALLEL = ("expert parallelism (_moe_ep over a model axis wider "
                   "than 1) waits for ROADMAP Queue 1's expert-parallel "
                   "slice")


def build_model(cfg: ArchConfig, policy: PrecisionPolicy | None = None,
                device: str | torch.device | None = None, *, mesh=None,
                fsdp_params: bool = False) -> LMModel:
    """The model handle; with ``mesh`` its parameters are expected as
    DTensors on that mesh (``runtime/train_loop.py``).  A mesh takes the
    dense decoders (GQA; the ``dense`` and ``vlm`` families): a MoE config
    on a ``model`` axis wider than 1 raises naming the expert-parallel
    slice, and the other families (MoE, SSM, hybrid, enc-dec) raise on
    any mesh."""
    if policy is None:
        policy = PrecisionPolicy(default="bf16", exempt=DEFAULT_EXEMPT)
    if mesh is not None and cfg.is_moe \
            and axis_sizes(mesh).get("model", 1) > 1:
        raise NotImplementedError(f"{cfg.name}: {EXPERT_PARALLEL}")
    if mesh is not None and (cfg.family not in MESH_FAMILIES or cfg.use_mla):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family on a device mesh waits "
            f"with expert parallelism (ROADMAP Queue 1)")
    return LMModel(cfg=cfg, device=resolve_device(device), policy=policy,
                   mesh=mesh, fsdp_params=fsdp_params)
