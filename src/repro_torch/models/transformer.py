"""Model assembly: decoder-only LMs of the dense, MoE, SSM and hybrid
families, and the encoder-decoder family (whisper).

Block taxonomy (``cfg.family``), as the JAX package's:

- dense | vlm : ``[attn_norm → attn → +res, mlp_norm → mlp → +res] × L``;
- moe         : the same with the MoE FFN (``moe``) in the MLP's place,
                and MLA attention with ``cfg.use_mla``;
- ssm (xLSTM) : ``[norm_m → mLSTM → +res, norm_s → sLSTM (+ its FFN) →
                +res] × L/2`` (:class:`XLSTMBlock`);
- hybrid      : segments of ``hybrid_period`` Mamba2 blocks
                (:class:`MambaBlock`), each followed by the ONE
                weight-shared attention+MLP block ``shared`` (zamba2);
- audio (``cfg.enc_dec``, :class:`EncDec`): an encoder of dense blocks
                (non-causal, no RoPE, sinusoid positions) over the
                frames, and a decoder whose blocks add a cross-attention
                over the encoder's output (:class:`DecBlock`).

The JAX package stacks the block parameters on a leading layer axis and
scans over them; here the blocks are an ``nn.ModuleList`` walked by a
Python loop.  Every decode cache keeps one stacked tensor per cached
quantity — the paged pool ``(L, P, ps, KV, D)``, the contiguous cache
``(L, B, S, KV, D)``, MLA's compressed ``ckv`` (L, B, S, kv_lora) and
``krope`` (L, B, S, rope), the recurrent states ``(L, B, ...)`` of the
SSM mixers and zamba2's shared-attention cache, stacked once per
application ``(L / period, B, S, KV, D)``, the enc-dec decoder's self
cache and its ``cross_k``/``cross_v`` (L, B, F, KV, D) — and layer ``l``
receives the view ``stack[l]``, so the layers' in-place writes land in
the stack (and the engine can swap pages out as ``pool[:, pages]``).
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.distributed.tensor import Shard
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.common import (Ctx, Norm, dense_init, embed_init,
                                       linear, norm_apply, shard_hidden,
                                       sinusoid_positions)
from repro_torch.parallel.sharding import batch_placements, is_dtensor


# ----------------------------------------------------------------- remat
def _dots_policy(ctx, op, *args, **kwargs):
    """``"dots"``: save the outputs of plain matrix products — ``mm`` and
    ``addmm``, products with no batch dimension, as JAX's
    ``dots_with_no_batch_dims_saveable``, and ``repro_torch::matmul``,
    the weight products of ``linear`` over more than one token on the
    card or over DTensors — and the int8 product's (``quant_matmul``'s
    kernel launch, an op of its own so that the policy sees it and the
    backward does not launch it again); recompute the rest (the
    attention's batched products among it)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
              torch.ops.repro_torch.matmul.default,
              torch.ops.repro_torch.int8_matmul.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_dots_context = functools.partial(create_selective_checkpoint_contexts,
                                  _dots_policy)


def _dots_moe_context():
    """``"dots+moe"``: :func:`_dots_policy`, and the output of each MoE
    layer's dispatch all-to-all saved (the reference's ``"moe_recv"``),
    so that the backward's recompute does not exchange the tokens again.
    An expert-parallel layer runs two all-to-alls, the dispatch first
    (``layers._moe_ep``); the policy counts them, in the forward and in
    the recompute alike, and saves every other one."""
    seen = {False: 0, True: 0}
    a2a = torch.ops._c10d_functional.all_to_all_single.default

    def policy(ctx, op, *args, **kwargs):
        if op is a2a:
            i = seen[ctx.is_recompute]
            seen[ctx.is_recompute] += 1
            return (CheckpointPolicy.MUST_SAVE if i % 2 == 0
                    else CheckpointPolicy.PREFER_RECOMPUTE)
        return _dots_policy(ctx, op, *args, **kwargs)
    return create_selective_checkpoint_contexts(policy)


def _remat(cfg: ArchConfig, fn):
    """``fn`` (one block's apply) under ``cfg.remat``, the counterpart of
    the JAX package's ``_remat``: ``"none"`` keeps every activation for
    the backward; ``"full"`` keeps the block's inputs and recomputes the
    rest; ``"dots"`` also keeps the products' outputs (:func:`_dots_policy`);
    ``"dots+moe"`` the products' and the expert-parallel dispatch's
    (:func:`_dots_moe_context`; off a mesh there is no dispatch and it
    is ``"dots"``).  It applies only while autograd records the block
    (grad enabled, and its input or one of its parameters requiring
    grad): the cached paths and evaluation run without it.  The result is
    bit for bit the same; only what the backward keeps and recomputes
    changes."""
    if cfg.remat == "none":
        return fn
    kw = ({} if cfg.remat == "full" else
          {"context_fn": _dots_moe_context} if cfg.remat == "dots+moe"
          else {"context_fn": _dots_context})

    def records(args) -> bool:
        return torch.is_grad_enabled() and any(
            a.requires_grad if isinstance(a, torch.Tensor)
            else isinstance(a, nn.Module)
            and any(p.requires_grad for p in a.parameters()) for a in args)

    def wrapped(*args):
        if not records(args):
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


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


class XLSTMBlock(nn.Module):
    """One xLSTM double block: an mLSTM block and an sLSTM block."""

    def __init__(self, cfg: ArchConfig, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.norm_m = Norm(cfg.norm, cfg.d_model, cfg.pdt, device)
        self.mlstm = S.MLSTM(cfg, device, gen)
        self.norm_s = Norm(cfg.norm, cfg.d_model, cfg.pdt, device)
        self.slstm = S.SLSTM(cfg, device, gen)


class MambaBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        self.norm = Norm(cfg.norm, cfg.d_model, cfg.pdt, device)
        self.mixer = S.Mamba2(cfg, device, gen)


class LM(nn.Module):
    """Parameters of a decoder-only LM, named as the JAX package's pytree
    (``embed``, ``blocks.{i}.attn.wq``, ``blocks.{i}.moe.w_gate``,
    ``blocks.{i}.mlstm.w_up``, ``blocks.{i}.mixer.in_proj``,
    ``shared.attn.wq``, ``final_norm.scale``, ``lm_head``).  ``blocks``
    holds ``n_layers // 2`` :class:`XLSTMBlock` pairs for the ``ssm``
    family, ``n_layers`` :class:`MambaBlock` for ``hybrid`` (which also
    gets zamba2's one weight-shared attention+MLP block ``shared``, a
    dense :class:`Block`), and ``n_layers`` :class:`Block` otherwise.
    With a generator every weight is drawn in init order; without one
    the module is allocated uninitialised for ``load_state_dict``."""

    AXES = {"embed": ("vocab", "embed"), "lm_head": ("embed", "vocab")}

    def __init__(self, cfg: ArchConfig, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        vp = padded_vocab(cfg)
        emb = (embed_init(gen, vp, cfg.d_model, cfg.pdt) if gen is not None
               else torch.empty((vp, cfg.d_model), dtype=cfg.pdt,
                                device=device))
        self.embed = L._param(emb)
        if cfg.family == "ssm":
            blocks = (XLSTMBlock(cfg, device, gen)
                      for _ in range(cfg.n_layers // 2))
        elif cfg.family == "hybrid":
            blocks = (MambaBlock(cfg, device, gen)
                      for _ in range(cfg.n_layers))
        else:
            blocks = (Block(cfg, device, gen) for _ in range(cfg.n_layers))
        self.blocks = nn.ModuleList(blocks)
        if cfg.family == "hybrid":
            self.shared = Block(cfg, device, gen)
        self.final_norm = Norm(cfg.norm, cfg.d_model, cfg.pdt, device)
        if not cfg.tie_embeddings:
            head = (dense_init(gen, cfg.d_model, vp, cfg.pdt)
                    if gen is not None
                    else torch.empty((cfg.d_model, vp), dtype=cfg.pdt,
                                     device=device))
            self.lm_head = L._param(head)


    def param_tree(self, per_block: bool = False) -> dict:
        """The JAX package's parameter pytree of this model, in its order
        (``embed``, ``blocks``, ``shared``, ``final_norm``, ``lm_head``),
        for the design flow's path-keyed view
        (``sparsity/masks.py::flatten_params``).
        ``blocks`` holds one stacked leaf per block parameter, (L, ...) in
        the JAX layout and keys sorted as the JAX stack sorts them.  A
        stacked matrix is a shape-only ``meta`` tensor, so the view copies
        no weight; the design flow reads only the shape of a 3-D leaf.  A
        stacked vector (biases, norm scales: L x d, a few hundred KB) is
        a real copy, since it is 2-D there and may be pruned like any
        2-D weight.  The other leaves are this module's own parameters,
        zamba2's unstacked ``shared`` block among them.

        With ``per_block`` each stacked leaf is instead the list of the
        blocks' own parameters, in layer order: the tree that training
        differentiates and updates (``optim/optimizers.py``)."""
        tree = {"embed": self.embed,
                "blocks": _stacked_tree(self.blocks, per_block)}
        if hasattr(self, "shared"):
            tree["shared"] = {}
            for name, t in self.shared.named_parameters():
                _put(tree["shared"], name, t)
        tree["final_norm"] = dict(self.final_norm.named_parameters())
        if hasattr(self, "lm_head"):
            tree["lm_head"] = self.lm_head
        return tree


def _stacked_tree(blocks: nn.ModuleList, per_block: bool) -> dict:
    """The block parameters of ``blocks`` as the JAX layout's stacked
    subtree (keys sorted): a shape-only (L, …) ``meta`` leaf for a
    matrix, a real (L, d) stack for a vector, or with ``per_block`` the
    list of the blocks' own tensors (:meth:`LM.param_tree`)."""
    stacked: dict = {}
    for name, _ in blocks[0].named_parameters():
        layers = [blk.get_parameter(name) for blk in blocks]
        t = layers[0]
        if per_block:
            leaf = layers
        elif t.ndim == 1:
            leaf = torch.stack([p.detach() for p in layers])
        else:
            leaf = torch.empty((len(layers), *t.shape), dtype=t.dtype,
                               device="meta")
        _put(stacked, name, leaf)
    return _sorted_tree(stacked)


def module_axes(module: nn.Module) -> dict:
    """The JAX package's logical-axes tree of ``module``'s parameters,
    in its layout: each parameter's axes from its owner's ``AXES``, a
    :class:`Norm`'s ``(axis,)`` from its parent's entry (``"embed"`` when
    there is none), and a block list as one stacked subtree whose axes
    lead with ``"layers"``."""
    table = getattr(type(module), "AXES", {})
    out: dict = {}
    for name, _ in module.named_parameters(recurse=False):
        out[name] = table[name]
    for name, child in module.named_children():
        if isinstance(child, Norm):
            ax = (table.get(name, "embed"),)
            out[name] = {n: ax for n, _ in child.named_parameters()}
        elif isinstance(child, nn.ModuleList):
            out[name] = _prefix_layers(module_axes(child[0]))
        else:
            out[name] = module_axes(child)
    return out


def _prefix_layers(axes):
    if isinstance(axes, dict):
        return {k: _prefix_layers(v) for k, v in axes.items()}
    return ("layers",) + tuple(axes)


def _put(tree: dict, name: str, leaf) -> None:
    """``tree[a][b][c] = leaf`` for the dotted ``name`` ``a.b.c``."""
    *parents, last = name.split(".")
    for part in parents:
        tree = tree.setdefault(part, {})
    tree[last] = leaf


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
    return shard_hidden(ctx, x + f), cache


def xlstm_block_apply(ctx: Ctx, cfg: ArchConfig, p: XLSTMBlock, x,
                      positions, cache):
    """mLSTM then sLSTM, each pre-normed with a residual; ``cache`` is the
    pair's ``{"mlstm": …, "slstm": …}`` state, updated in place."""
    mc = cache["mlstm"] if cache is not None else None
    sc = cache["slstm"] if cache is not None else None
    y, _ = S.mlstm_apply(ctx, cfg, p.mlstm, norm_apply(cfg.norm, p.norm_m, x),
                         mc)
    x = x + y
    y, _ = S.slstm_apply(ctx, cfg, p.slstm, norm_apply(cfg.norm, p.norm_s, x),
                         sc)
    return shard_hidden(ctx, x + y), cache


def mamba_block_apply(ctx: Ctx, cfg: ArchConfig, p: MambaBlock, x,
                      positions, cache):
    y, cache = S.mamba2_apply(ctx, cfg, p.mixer,
                              norm_apply(cfg.norm, p.norm, x), cache)
    return shard_hidden(ctx, x + y), cache


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i``'s views ``t[i]`` of a nested dict of stacked states."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _attention_layer(cache: dict, i: int) -> dict:
    """Layer ``i`` of a stacked contiguous attention cache: views of its
    ``k``/``v`` (MLA: ``ckv``/``krope``) and its ``pos`` as an int."""
    lc = {name: t[i] for name, t in cache.items() if name != "pos"}
    lc["pos"] = int(cache["pos"][i])
    return lc


def _with_pos(cache: dict, new_pos: list) -> dict:
    return dict(cache, pos=torch.tensor(new_pos, dtype=torch.int32))


def _cache_pos(cfg: ArchConfig, cache: dict) -> int:
    """The current absolute position of a contiguous cache: xLSTM's one
    ``pos``, the first shared-attention application's under hybrid, the
    first layer's otherwise."""
    if cfg.family == "ssm":
        return int(cache["pos"])
    if cfg.family == "hybrid":
        return int(cache["shared"]["pos"][0])
    return int(cache["pos"][0])


def _hybrid_stack(ctx: Ctx, cfg: ArchConfig, params: LM, x, positions,
                  cache):
    """zamba2: the Mamba2 blocks in segments of ``hybrid_period``, each
    segment followed by the one weight-shared attention+MLP block with
    the cache of that application (``cache["shared"]`` stacks one per
    segment).  Returns (x, cache)."""
    period = cfg.hybrid_period
    new_pos = []
    block_apply = _remat(cfg, mamba_block_apply)
    for i, blk in enumerate(params.blocks):
        lc = None if cache is None else _layer(cache["mamba"], i)
        x, _ = block_apply(ctx, cfg, blk, x, positions, lc)
        if (i + 1) % period:
            continue
        sc = None if cache is None else _attention_layer(cache["shared"],
                                                         i // period)
        x, sc = lm_block_apply(ctx, cfg, params.shared, x, positions, sc)
        if sc is not None:
            new_pos.append(sc["pos"])
    if cache is None:
        return x, None
    return x, {"mamba": cache["mamba"],
               "shared": _with_pos(cache["shared"], new_pos)}


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
    (``ctx.decode``) places the tokens at ``pos + arange(S)``
    (:func:`_cache_pos`); a prefill starts at position 0.  ``k``/``v``
    (MLA: ``ckv``/``krope``) and the recurrent states are written in
    place, and the returned cache carries the advanced ``pos``: each
    attention layer's (each shared-attention application's under
    hybrid), or xLSTM's one ``pos`` plus S.
    """
    if tokens.ndim == 2:
        x = _embed(params.embed, tokens).to(cfg.adt)
    else:
        x = tokens.to(cfg.adt)
    b, s = x.shape[:2]
    paged = cache is not None and "block_tables" in cache
    if positions is None:
        if paged and ctx.decode:
            positions = L.ragged_prefill_positions(cache["seq_lens"], s)
        elif cache is not None and ctx.decode:
            positions = _cache_pos(cfg, cache) + torch.arange(
                s, device=x.device)
        else:
            positions = torch.arange(s, device=x.device)
    x = shard_hidden(ctx, x)

    if cfg.family == "hybrid":
        x, new_cache = _hybrid_stack(ctx, cfg, params, x, positions, cache)
    elif cfg.family == "ssm":
        block_apply = _remat(cfg, xlstm_block_apply)
        for i, blk in enumerate(params.blocks):
            lc = None if cache is None else _layer(cache["blocks"], i)
            x, _ = block_apply(ctx, cfg, blk, x, positions, lc)
        new_cache = None if cache is None else {
            "blocks": cache["blocks"], "pos": int(cache["pos"]) + s}
    else:
        new_pos = []
        block_apply = _remat(cfg, lm_block_apply)
        for i, blk in enumerate(params.blocks):
            lc = None
            if paged:
                # block tables / seq_lens are batch state shared by every
                # layer — injected here; prefill_lens rides along only
                # during a batched ragged admission dispatch, and its
                # presence routes layers.attention to the ragged-prefill
                # branch
                lc = {"k_pages": cache["blocks"]["k_pages"][i],
                      "v_pages": cache["blocks"]["v_pages"][i],
                      "block_tables": cache["block_tables"],
                      "seq_lens": cache["seq_lens"]}
                if "prefill_lens" in cache:
                    lc["prefill_lens"] = cache["prefill_lens"]
            elif cache is not None:
                lc = _attention_layer(cache, i)
            x, lc = block_apply(ctx, cfg, blk, x, positions, lc)
            if lc is not None and not paged:
                new_pos.append(lc["pos"])
        new_cache = None
        if paged:
            new_cache = {"blocks": cache["blocks"],
                         "block_tables": cache["block_tables"],
                         "seq_lens": cache["seq_lens"]}
        elif cache is not None:
            new_cache = _with_pos(cache, new_pos)
    x = norm_apply(cfg.norm, params.final_norm, x)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = linear(ctx, "lm_head", x, head)
    return logits, new_cache


def _embed(table, tokens):
    """``table[tokens]``.  On a mesh, outside autograd, a table whose
    vocabulary is sharded takes ``F.embedding``'s vocab-parallel rule
    (each rank looks up the rows it holds, a sum combines them) rather
    than gathering it; otherwise each rank indexes the whole table with
    its batch rows (``local_map``), the table's gradient a partial sum
    over the data-parallel axes — the unsharded op on each rank."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    rows = batch_placements(mesh, rows=tokens.shape[0])
    if not torch.is_grad_enabled() and any(
            isinstance(p, Shard) and p.dim == 0 and mesh.size(i) > 1
            for i, p in enumerate(table.placements)):
        # the partial rows are summed at once, while DTensor still holds
        # the lookup's mask
        return torch.nn.functional.embedding(tokens, table).redistribute(
            mesh, rows)
    whole = (Replicate(),) * mesh.ndim
    grad = tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in rows)
    return local_map(lambda t, i: t[i], out_placements=list(rows),
                     in_placements=(whole, rows),
                     in_grad_placements=(grad, rows), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def _stack(n: int, state: dict) -> dict:
    """``n`` copies of one layer's state, stacked on a leading axis."""
    return {k: t[None].repeat(n, *([1] * t.dim())) for k, t in state.items()}


def _attention_cache(cfg: ArchConfig, n: int, batch: int, seq_len: int,
                     dtype, device) -> dict:
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


def init_lm_cache(cfg: ArchConfig, batch: int, seq_len: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    """The stacked contiguous decode cache of the whole model, the JAX
    package's pytree, on ``device``:

    - dense / MoE: ``k`` and ``v`` (L, B, cache_len, KV, hd) zeros — with
      MLA ``ckv`` (L, B, seq_len, kv_lora_rank) and ``krope`` (L, B,
      seq_len, rope_head_dim) — and the per-layer ``pos`` (L,) int32;
    - ssm: ``{"blocks": {"mlstm": {conv, C, n, m}, "slstm": {h, c, n,
      m}}, "pos": 0}``, each state stacked over the L/2 pairs;
    - hybrid: ``{"mamba": {conv, ssd}, "shared": {k, v, pos}}``, the
      Mamba2 states stacked over the L layers and the shared attention's
      cache over its L / hybrid_period applications.

    The recurrent states are fp32 whatever ``dtype``, which reaches only
    the attention caches (as in the JAX package, whose
    ``init_lm_cache`` calls the state inits without a dtype).  ``pos``
    stays on the host (a tensor, or xLSTM's int): positions, write slots
    and masks derive from it without a device round trip."""
    if cfg.family == "ssm":
        n = cfg.n_layers // 2
        return {"blocks": {
            "mlstm": _stack(n, S.init_mlstm_state(cfg, batch, device=device)),
            "slstm": _stack(n, S.init_slstm_state(cfg, batch, device))},
            "pos": 0}
    if cfg.family == "hybrid":
        return {"mamba": _stack(cfg.n_layers, S.init_mamba2_state(
                    cfg, batch, device=device)),
                "shared": _attention_cache(
                    cfg, cfg.n_layers // cfg.hybrid_period, batch, seq_len,
                    dtype, device)}
    return _attention_cache(cfg, cfg.n_layers, batch, seq_len, dtype,
                            device)


def cache_axes(cfg: ArchConfig) -> dict:
    """The logical axes of :func:`init_lm_cache`'s tree (of
    :func:`init_encdec_cache`'s for an enc-dec config), the JAX
    package's: each layer's axes behind a leading ``"layers"``."""
    if cfg.enc_dec:
        kv = ("layers", "batch", "frames", "kv_heads", "head_dim")
        return {"self": _prefix_layers(L.ATTN_CACHE_AXES), "cross_k": kv,
                "cross_v": kv}
    if cfg.family == "ssm":
        return {"blocks": _prefix_layers({"mlstm": S.MLSTM_STATE_AXES,
                                          "slstm": S.SLSTM_STATE_AXES}),
                "pos": ()}
    if cfg.family == "hybrid":
        return {"mamba": _prefix_layers(S.MAMBA2_STATE_AXES),
                "shared": _prefix_layers(L.ATTN_CACHE_AXES)}
    return _prefix_layers(L.MLA_CACHE_AXES if cfg.use_mla
                          else L.ATTN_CACHE_AXES)


# ======================================================== whisper enc-dec
def _enc_cfg(cfg: ArchConfig) -> ArchConfig:
    """Both stacks' attention: no RoPE, no sliding window."""
    return cfg.replace(use_rope=False, sliding_window=0)


class DecBlock(Block):
    """A decoder block: :class:`Block`'s self-attention and MLP, and the
    cross-attention over the encoder's output (``cross_norm``,
    ``cross``)."""

    def __init__(self, cfg: ArchConfig, device=None,
                 gen: torch.Generator | None = None):
        super().__init__(cfg, device, gen)
        self.cross_norm = Norm(cfg.norm, cfg.d_model, cfg.pdt, device)
        self.cross = L.Attention(cfg, device, gen)


class EncDec(nn.Module):
    """Parameters of an encoder-decoder model, named as the JAX package's
    ``init_encdec`` pytree: ``enc_blocks.{i}.{attn_norm, attn, mlp_norm,
    mlp}``, ``dec_blocks.{i}.{…, cross_norm, cross}``, ``embed`` (vocab,
    d; also the tied ``lm_head``), ``enc_norm`` and ``dec_norm``.  With a
    generator every weight is drawn in init order; without one the
    module is allocated uninitialised for ``load_state_dict``."""

    AXES = {"embed": ("vocab", "embed")}

    def __init__(self, cfg: ArchConfig, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        ecfg = _enc_cfg(cfg)
        self.enc_blocks = nn.ModuleList(Block(ecfg, device, gen)
                                        for _ in range(cfg.n_enc_layers))
        self.dec_blocks = nn.ModuleList(DecBlock(ecfg, device, gen)
                                        for _ in range(cfg.n_layers))
        emb = (embed_init(gen, cfg.vocab_size, cfg.d_model, cfg.pdt)
               if gen is not None
               else torch.empty((cfg.vocab_size, cfg.d_model), dtype=cfg.pdt,
                                device=device))
        self.embed = L._param(emb)
        self.enc_norm = Norm(cfg.norm, cfg.d_model, cfg.pdt, device)
        self.dec_norm = Norm(cfg.norm, cfg.d_model, cfg.pdt, device)
        # the sinusoid tables on the model's device, built once a model
        # and freed with it; not saved (they follow from the config)
        self.register_buffer("enc_pos", sinusoid_positions(
            cfg.n_frames, cfg.d_model).to(device), persistent=False)
        self.register_buffer("dec_pos", sinusoid_positions(
            cfg.n_frames * 32, cfg.d_model).to(device), persistent=False)


    def param_tree(self, per_block: bool = False) -> dict:
        """The JAX package's parameter pytree of this model
        (``enc_blocks`` and ``dec_blocks`` stacked as
        :meth:`LM.param_tree` stacks ``blocks``, ``embed``, ``enc_norm``,
        ``dec_norm``)."""
        return {"enc_blocks": _stacked_tree(self.enc_blocks, per_block),
                "dec_blocks": _stacked_tree(self.dec_blocks, per_block),
                "embed": self.embed,
                "enc_norm": dict(self.enc_norm.named_parameters()),
                "dec_norm": dict(self.dec_norm.named_parameters())}


def init_encdec(gen: torch.Generator, cfg: ArchConfig) -> EncDec:
    """Randomly initialised enc-dec parameters on ``gen``'s device."""
    return EncDec(cfg, gen.device, gen)


def _like_x(x, t):
    """``t`` (a sinusoid table's rows, on the model's device) as a
    replicated DTensor on ``x``'s mesh when ``x`` is a DTensor — every
    rank holds the same table — so that the two add; else ``t``."""
    if not is_dtensor(x):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def encdec_encode(ctx: Ctx, cfg: ArchConfig, params: EncDec, frames):
    """frames: (B, S, d) precomputed conv-frontend embeddings, S <=
    n_frames.  Returns the encoder's output (B, S, d).  On a mesh the
    activations keep their batch rows (``shard_hidden``) between
    blocks."""
    s = frames.shape[1]
    x = frames.to(cfg.adt)
    x = shard_hidden(ctx, x + _like_x(x, params.enc_pos[:s].to(cfg.adt)))
    positions = torch.arange(s, device=frames.device)
    block_apply = _remat(cfg, _enc_block_apply)
    for blk in params.enc_blocks:
        x = block_apply(ctx, cfg, blk, x, positions)
    return norm_apply(cfg.norm, params.enc_norm, x)


def _enc_block_apply(ctx: Ctx, cfg: ArchConfig, blk: Block, x, positions):
    h = norm_apply(cfg.norm, blk.attn_norm, x)
    a, _ = L.attention(ctx, _enc_cfg(cfg), blk.attn, h, positions,
                       causal=False)
    x = x + a
    h = norm_apply(cfg.norm, blk.mlp_norm, x)
    return shard_hidden(ctx, x + L.mlp(ctx, cfg, blk.mlp, h))


def _dec_block_apply(ctx: Ctx, cfg: ArchConfig, blk: DecBlock, x, positions,
                     sc, ck, cv, frame_pos):
    ecfg = _enc_cfg(cfg)
    h = norm_apply(cfg.norm, blk.attn_norm, x)
    a, sc = L.attention(ctx, ecfg, blk.attn, h, positions, sc)
    x = x + a
    h = norm_apply(cfg.norm, blk.cross_norm, x)
    a, _ = L.attention(ctx, ecfg, blk.cross, h, positions,
                       kv_override=(ck, cv, frame_pos))
    x = x + a
    h = norm_apply(cfg.norm, blk.mlp_norm, x)
    return shard_hidden(ctx, x + L.mlp(ctx, cfg, blk.mlp, h)), sc


def encdec_decode(ctx: Ctx, cfg: ArchConfig, params: EncDec, tokens,
                  enc_out=None, cache=None):
    """The decoder over ``tokens`` (B, S).  Returns (logits, cache).

    Uncached (``cache is None``, the loss path): causal self-attention
    over the tokens and cross K/V projected from ``enc_out`` on the fly.
    With a cache (:func:`init_encdec_cache`) the cross-attention reads
    its ``cross_k``/``cross_v``, so decode never touches the encoder;
    a prefill (not ``ctx.decode``) fills the self cache from position 0,
    a decode call attends it at its ``pos`` (flash_decode for one
    token).  Positions index the decoder's ``n_frames * 32``-row sinusoid
    table clamped to its last row, as the JAX package's gather clamps an
    out-of-range index.  On a mesh (DTensor tokens and parameters) the
    cache and the cross K/V are DTensors placed by the rules, and the
    activations keep their batch rows between blocks."""
    ecfg = _enc_cfg(cfg)
    x = _embed(params.embed, tokens).to(cfg.adt)
    s = tokens.shape[1]
    dev = x.device
    positions = torch.arange(s, device=dev)
    if cache is not None and ctx.decode:
        positions = int(cache["self"]["pos"][0]) + positions
    table = params.dec_pos
    x = shard_hidden(ctx, x + _like_x(x, table[positions.clamp(
        max=table.shape[0] - 1)].to(cfg.adt)))
    frame_pos = torch.arange(cfg.n_frames, device=dev)
    new_pos = []
    block_apply = _remat(cfg, _dec_block_apply)
    for i, blk in enumerate(params.dec_blocks):
        if cache is None:
            sc = None
            ck, cv = L._kv(ctx, ecfg, blk.cross, enc_out)
        else:
            sc = _attention_layer(cache["self"], i)
            ck, cv = cache["cross_k"][i], cache["cross_v"][i]
        x, sc = block_apply(ctx, cfg, blk, x, positions, sc, ck, cv,
                            frame_pos)
        if sc is not None:
            new_pos.append(sc["pos"])
    new_cache = None
    if cache is not None:
        new_cache = dict(cache, self=_with_pos(cache["self"], new_pos))
    x = norm_apply(cfg.norm, params.dec_norm, x)
    logits = linear(ctx, "lm_head", x, params.embed.T)
    return logits, new_cache


def init_encdec_cache(ctx: Ctx, cfg: ArchConfig, params: EncDec | None,
                      batch: int, seq_len: int, frames=None,
                      dtype=torch.bfloat16, device=None) -> dict:
    """The decoder's cache on ``device``: ``self`` — the contiguous
    attention cache ``{k, v}`` (L, B, seq_len, KV, hd) with the per-layer
    host ``pos`` (L,) — and ``cross_k``/``cross_v`` (L, B, n_frames, KV,
    hd), zeros, or with ``frames`` filled by :func:`encode_cross_kv`."""
    n = cfg.n_layers
    kvshape = (n, batch, cfg.n_frames, cfg.n_kv_heads, cfg.hd)
    cache = {"self": _attention_cache(_enc_cfg(cfg), n, batch, seq_len,
                                      dtype, device),
             "cross_k": torch.zeros(kvshape, dtype=dtype, device=device),
             "cross_v": torch.zeros(kvshape, dtype=dtype, device=device)}
    if frames is not None:
        encode_cross_kv(ctx, cfg, params, frames, cache)
    return cache


def encode_cross_kv(ctx: Ctx, cfg: ArchConfig, params: EncDec, frames,
                    cache: dict) -> None:
    """Encode ``frames`` once and write each decoder layer's
    cross-attention K/V of the encoder's output into ``cache``'s
    ``cross_k``/``cross_v`` in place, cast to the cache's dtype.  A
    DTensor cache keeps its placements: each rank writes its shard of the
    K/V, redistributed to them, into its part of the stack."""
    ecfg = _enc_cfg(cfg)
    enc_out = encdec_encode(ctx, cfg, params, frames)
    for i, blk in enumerate(params.dec_blocks):
        for dst, t in zip((cache["cross_k"][i], cache["cross_v"][i]),
                          L._kv(ctx, ecfg, blk.cross, enc_out)):
            if is_dtensor(dst):
                t = t.redistribute(dst.device_mesh, dst.placements)
            dst.copy_(t)
