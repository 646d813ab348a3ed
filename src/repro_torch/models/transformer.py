"""Model assembly: dense decoder-only LMs.

Block: ``[attn_norm → attn → +res, mlp_norm → mlp → +res] × L``.  The JAX
package stacks the block parameters on a leading layer axis and scans
over them; here the blocks are an ``nn.ModuleList`` walked by a Python
loop.  The paged KV cache keeps one stacked ``(L, P, ps, KV, D)`` tensor
per K and V, and layer ``l`` receives the view ``pool[l]``, so the
layers' in-place page writes land in the stack and the engine can swap
pages out as ``pool[:, pages]``.

MoE, MLA, SSM, hybrid and encoder-decoder families are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.common import (Ctx, Norm, dense_init, embed_init,
                                       linear, norm_apply)


def _check_dense(cfg: ArchConfig) -> None:
    if (cfg.family not in ("dense", "vlm") or cfg.is_moe or cfg.use_mla
            or cfg.enc_dec or cfg.hybrid_period):
        raise NotImplementedError(
            f"{cfg.name}: family={cfg.family} is not ported yet; this port "
            f"covers dense GQA decoders")


def padded_vocab(cfg: ArchConfig) -> int:
    m = cfg.pad_vocab_to_multiple
    if not m:
        return cfg.vocab_size
    return -(-cfg.vocab_size // m) * m


class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.attn_norm = Norm(cfg.norm, cfg.d_model, cfg.pdt, device)
        self.attn = L.Attention(cfg, device, gen)
        self.mlp_norm = Norm(cfg.norm, cfg.d_model, cfg.pdt, device)
        self.mlp = L.MLP(cfg, device, gen)


class LM(nn.Module):
    """Parameters of a dense decoder-only LM, named as the JAX package's
    pytree (``embed``, ``blocks.{i}.attn.wq``, ``final_norm.scale``,
    ``lm_head``).  With a generator every weight is drawn in init order;
    without one the module is allocated uninitialised for
    ``load_state_dict``."""

    def __init__(self, cfg: ArchConfig, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        _check_dense(cfg)
        vp = padded_vocab(cfg)
        emb = (embed_init(gen, vp, cfg.d_model, cfg.pdt) if gen is not None
               else torch.empty((vp, cfg.d_model), dtype=cfg.pdt,
                                device=device))
        self.embed = L._param(emb)
        self.blocks = nn.ModuleList(Block(cfg, device, gen)
                                    for _ in range(cfg.n_layers))
        self.final_norm = Norm(cfg.norm, cfg.d_model, cfg.pdt, device)
        if not cfg.tie_embeddings:
            head = (dense_init(gen, cfg.d_model, vp, cfg.pdt)
                    if gen is not None
                    else torch.empty((cfg.d_model, vp), dtype=cfg.pdt,
                                     device=device))
            self.lm_head = L._param(head)


def init_lm(gen: torch.Generator, cfg: ArchConfig) -> LM:
    """Randomly initialised parameters on ``gen``'s device."""
    return LM(cfg, gen.device, gen)


def lm_block_apply(ctx: Ctx, cfg: ArchConfig, p: Block, x, positions,
                   cache):
    h = norm_apply(cfg.norm, p.attn_norm, x)
    a, cache = L.attention(ctx, cfg, p.attn, h, positions, cache)
    x = x + a
    h = norm_apply(cfg.norm, p.mlp_norm, x)
    x = x + L.mlp(ctx, cfg, p.mlp, h)
    return x, cache


def lm_apply(ctx: Ctx, cfg: ArchConfig, params: LM, tokens, positions=None,
             cache=None):
    """tokens: int (B,S) — or float (B,S,D) pre-embedded.

    Returns (logits, cache).  With a paged cache (``"block_tables"`` in
    ``cache``) the positions are per request,
    ``ragged_prefill_positions(seq_lens, S)``: during an admission
    dispatch ``seq_lens`` carries the shared-prefix offsets and
    ``prefill_lens`` rides along, during decode it carries each request's
    length.  The engine owns the ``seq_lens`` increment; ``lm_apply`` only
    reads it.  The page pools are updated in place and the returned cache
    holds the same tensors.
    """
    if tokens.ndim == 2:
        x = params.embed[tokens].to(cfg.adt)
    else:
        x = tokens.to(cfg.adt)
    b, s = x.shape[:2]
    paged = cache is not None and "block_tables" in cache
    if cache is not None and not paged:
        raise NotImplementedError(
            "contiguous (non-paged) KV caches are not ported yet")
    if positions is None:
        if paged and ctx.decode:
            positions = L.ragged_prefill_positions(cache["seq_lens"], s)
        else:
            positions = torch.arange(s, device=x.device)

    for i, blk in enumerate(params.blocks):
        lc = None
        if paged:
            # block tables / seq_lens are batch state shared by every
            # layer — injected here; prefill_lens rides along only during
            # a batched ragged admission dispatch, and its presence routes
            # layers.attention to the ragged-prefill branch
            lc = {"k_pages": cache["blocks"]["k_pages"][i],
                  "v_pages": cache["blocks"]["v_pages"][i],
                  "block_tables": cache["block_tables"],
                  "seq_lens": cache["seq_lens"]}
            if "prefill_lens" in cache:
                lc["prefill_lens"] = cache["prefill_lens"]
        x, _ = lm_block_apply(ctx, cfg, blk, x, positions, lc)

    new_cache = None
    if paged:
        new_cache = {"blocks": cache["blocks"],
                     "block_tables": cache["block_tables"],
                     "seq_lens": cache["seq_lens"]}
    x = norm_apply(cfg.norm, params.final_norm, x)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = linear(ctx, "lm_head", x, head)
    return logits, new_cache
