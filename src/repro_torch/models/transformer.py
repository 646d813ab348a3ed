"""Model assembly: decoder-only LMs of the dense and MoE families.

Block: ``[attn_norm → attn → +res, mlp_norm → mlp → +res] × L``; in the
``moe`` family the MoE FFN (``moe``) takes the MLP's place, and with
``cfg.use_mla`` the attention is MLA.  The JAX package stacks the block
parameters on a leading layer axis and scans over them; here the blocks
are an ``nn.ModuleList`` walked by a Python loop.  Every decode cache
keeps one stacked tensor per cached quantity — the paged pool ``(L, P,
ps, KV, D)``, the contiguous cache ``(L, B, S, KV, D)`` and MLA's
compressed ``ckv`` (L, B, S, kv_lora) and ``krope`` (L, B, S, rope) —
and layer ``l`` receives the view ``stack[l]``, so the layers' in-place
writes land in the stack (and the engine can swap pages out as
``pool[:, pages]``).

The SSM, hybrid and encoder-decoder families are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.common import (Ctx, Norm, dense_init, embed_init,
                                       linear, norm_apply)


def check_ported(cfg: ArchConfig) -> None:
    """Refuse the families this port does not build yet: SSM, hybrid and
    encoder-decoder."""
    if (cfg.family not in ("dense", "vlm", "moe") or cfg.enc_dec
            or cfg.hybrid_period):
        raise NotImplementedError(
            f"{cfg.name}: family={cfg.family} is not ported yet; this port "
            f"covers dense and MoE decoders (GQA or MLA attention)")


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
        self.attn = (L.MLA if cfg.use_mla else L.Attention)(cfg, device, gen)
        self.mlp_norm = Norm(cfg.norm, cfg.d_model, cfg.pdt, device)
        if cfg.is_moe:
            self.moe = L.MoE(cfg, device, gen)
        else:
            self.mlp = L.MLP(cfg, device, gen)


class LM(nn.Module):
    """Parameters of a decoder-only LM, named as the JAX package's pytree
    (``embed``, ``blocks.{i}.attn.wq``, ``blocks.{i}.moe.w_gate``,
    ``final_norm.scale``, ``lm_head``).  With a generator every weight is drawn in init order;
    without one the module is allocated uninitialised for
    ``load_state_dict``."""

    def __init__(self, cfg: ArchConfig, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        check_ported(cfg)
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


    def param_tree(self, per_block: bool = False) -> dict:
        """The JAX package's parameter pytree of this model, in its order
        (``embed``, ``blocks``, ``final_norm``, ``lm_head``), for the design
        flow's path-keyed view (``sparsity/masks.py::flatten_params``).
        ``blocks`` holds one stacked leaf per block parameter, (L, ...) in
        the JAX layout and keys sorted as the JAX stack sorts them.  A
        stacked matrix is a shape-only ``meta`` tensor, so the view copies
        no weight; the design flow reads only the shape of a 3-D leaf.  A
        stacked vector (biases, norm scales: L x d, a few hundred KB) is
        a real copy, since it is 2-D there and may be pruned like any
        2-D weight.  The other leaves are this module's own parameters.

        With ``per_block`` each stacked leaf is instead the list of the
        blocks' own parameters, in layer order: the tree that training
        differentiates and updates (``optim/optimizers.py``)."""
        stacked: dict = {}
        names = [name for name, _ in self.blocks[0].named_parameters()]
        for name in names:
            node = stacked
            *parents, leaf = name.split(".")
            for part in parents:
                node = node.setdefault(part, {})
            layers = [blk.get_parameter(name) for blk in self.blocks]
            t = layers[0]
            if per_block:
                node[leaf] = layers
            elif t.ndim == 1:
                node[leaf] = torch.stack([p.detach() for p in layers])
            else:
                node[leaf] = torch.empty((len(layers), *t.shape),
                                         dtype=t.dtype, device="meta")
        tree = {"embed": self.embed, "blocks": _sorted_tree(stacked),
                "final_norm": dict(self.final_norm.named_parameters())}
        if hasattr(self, "lm_head"):
            tree["lm_head"] = self.lm_head
        return tree


def _sorted_tree(node: dict) -> dict:
    return {k: _sorted_tree(v) if isinstance(v, dict) else v
            for k, v in sorted(node.items())}


def init_lm(gen: torch.Generator, cfg: ArchConfig) -> LM:
    """Randomly initialised parameters on ``gen``'s device."""
    return LM(cfg, gen.device, gen)


def lm_block_apply(ctx: Ctx, cfg: ArchConfig, p: Block, x, positions,
                   cache):
    h = norm_apply(cfg.norm, p.attn_norm, x)
    if cfg.use_mla:
        a, cache = L.mla_attention(ctx, cfg, p.attn, h, positions, cache)
    else:
        a, cache = L.attention(ctx, cfg, p.attn, h, positions, cache)
    x = x + a
    h = norm_apply(cfg.norm, p.mlp_norm, x)
    if cfg.is_moe:
        f = L.moe_ffn(ctx, cfg, p.moe, h)
    else:
        f = L.mlp(ctx, cfg, p.mlp, h)
    return x + f, cache


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

    With a contiguous cache (:func:`init_lm_cache`) a decode call
    (``ctx.decode``) places the tokens at ``pos + arange(S)``; a prefill
    starts at position 0.  ``k``/``v`` (MLA: ``ckv``/``krope``) are
    written in place and the returned cache carries each layer's advanced
    ``pos``.
    """
    if tokens.ndim == 2:
        x = params.embed[tokens].to(cfg.adt)
    else:
        x = tokens.to(cfg.adt)
    b, s = x.shape[:2]
    paged = cache is not None and "block_tables" in cache
    if positions is None:
        if paged and ctx.decode:
            positions = L.ragged_prefill_positions(cache["seq_lens"], s)
        elif cache is not None and ctx.decode:
            positions = int(cache["pos"][0]) + torch.arange(s,
                                                            device=x.device)
        else:
            positions = torch.arange(s, device=x.device)

    new_pos = []
    stacked = () if cache is None or paged else [
        name for name in cache if name != "pos"]
    for i, blk in enumerate(params.blocks):
        lc = None
        if stacked:
            lc = {name: cache[name][i] for name in stacked}
            lc["pos"] = int(cache["pos"][i])
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
        x, lc = lm_block_apply(ctx, cfg, blk, x, positions, lc)
        if lc is not None and not paged:
            new_pos.append(lc["pos"])

    new_cache = None
    if paged:
        new_cache = {"blocks": cache["blocks"],
                     "block_tables": cache["block_tables"],
                     "seq_lens": cache["seq_lens"]}
    elif cache is not None:
        new_cache = {name: cache[name] for name in stacked}
        new_cache["pos"] = torch.tensor(new_pos, dtype=torch.int32)
    x = norm_apply(cfg.norm, params.final_norm, x)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = linear(ctx, "lm_head", x, head)
    return logits, new_cache


def init_lm_cache(cfg: ArchConfig, batch: int, seq_len: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    """The stacked contiguous decode cache of the whole model, the JAX
    package's pytree: ``k`` and ``v`` (L, B, cache_len, KV, hd) zeros on
    ``device`` — with MLA ``ckv`` (L, B, seq_len, kv_lora_rank) and
    ``krope`` (L, B, seq_len, rope_head_dim) — and the per-layer ``pos``
    (L,) int32 zeros.  ``pos`` stays a host tensor: positions, write slots
    and masks derive from it without a device round trip."""
    n = cfg.n_layers
    if cfg.use_mla:
        cache = {"ckv": torch.zeros((n, batch, seq_len, cfg.kv_lora_rank),
                                    dtype=dtype, device=device),
                 "krope": torch.zeros((n, batch, seq_len, cfg.rope_head_dim),
                                      dtype=dtype, device=device)}
    else:
        shape = (n, batch, L.cache_len_for(cfg, seq_len), cfg.n_kv_heads,
                 cfg.hd)
        cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)}
    cache["pos"] = torch.zeros((n,), dtype=torch.int32)
    return cache
