"""Attention (GQA and MLA), MLPs and the MoE FFN.

GQA attention has the JAX package's execution paths:

- uncached (train / plain prefill): chunked memory-efficient attention
  (:func:`mea_attention`, online softmax over kv chunks);
- contiguous decode cache (:func:`init_attention_cache`): prefill runs
  the chunked attention and fills the cache (ring-rotated under a
  sliding window, :func:`_fill_contiguous_cache`); one-token decode
  writes the token's K/V at ``pos`` (``pos % cache_len`` in the ring)
  and attends through flash_decode (:func:`_contiguous_attention_decode`);
- paged decode and batched ragged admission prefill over a block-table
  page pool (:func:`_paged_attention_decode`,
  :func:`_paged_attention_prefill`).

The decode and paged branches always call their kernel's wrapper
(kernels/flash_decode.py, flash_decode_paged.py, flash_prefill_ragged.py),
which launches the CUDA kernel for a CUDA tensor and runs the plain
PyTorch version (built from :func:`_masked_decode_attention` and
:func:`mea_attention`) for a CPU tensor.

MLA (:func:`mla_attention`) and the MoE FFN (:func:`moe_ffn`) are
computed by the JAX package outside any Pallas kernel, and here with
plain PyTorch products: MLA's uncached and prefill paths through
:func:`mea_attention`, its decode as fp32 attention over the whole
compressed cache; off a mesh the MoE FFN routes each token through its
top-k experts in fp32, in fixed row blocks on the card; on a mesh it is
the reference's expert parallelism (:func:`_moe_ep`: capacity, bf16
expert products, all-to-alls over the ``model`` axis).
"""

from __future__ import annotations

import contextlib
import functools
import math
import types

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (Ctx, Norm, act_fn, apply_rope,
                                       dense_init, linear, norm_apply,
                                       row_invariant_matmul)
from repro_torch.parallel.sharding import (DP_AXES, axis_sizes,
                                           batch_placements, is_dtensor)
from repro_torch.quant.policy import INT8, quantize_int8

NEG_INF = -1e30
EMPTY_POS = 2**30


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _weight(gen: torch.Generator | None, d_in: int, d_out: int, dtype,
            device, scale: float | None = None) -> torch.Tensor:
    """A ``(d_in, d_out)`` weight drawn from ``gen`` as ``dense_init``
    draws it, or left uninitialised on ``device`` without a generator."""
    if gen is not None:
        return dense_init(gen, d_in, d_out, dtype, scale)
    return torch.empty((d_in, d_out), dtype=dtype, device=device)


# =====================================================================
# Attention
# =====================================================================
class Attention(nn.Module):
    """Attention parameters: ``wq/wk/wv/wo`` stored ``(in, out)``, the
    optional QKV biases and q/k norms.  With a generator the weights are
    drawn as the JAX package's ``init_attention`` draws them (biases 0,
    norms 1); without one they are left uninitialised for
    ``load_state_dict``."""

    # the JAX package's logical axes of each parameter; a Norm child's
    # entry names the axis of its scale and bias ("embed" when absent)
    AXES = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
            "wv": ("embed", "kv_heads"), "wo": ("heads", "embed"),
            "bq": ("heads",), "bk": ("kv_heads",), "bv": ("kv_heads",),
            "q_norm": "head_dim", "k_norm": "head_dim"}

    def __init__(self, cfg: ArchConfig, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        h, kv = cfg.n_heads, cfg.n_kv_heads
        dt = cfg.pdt
        shapes = {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
                  "wo": (h * hd, d)}
        for name, (d_in, d_out) in shapes.items():
            scale = 1.0 / math.sqrt(h * hd) if name == "wo" else None
            setattr(self, name,
                    _param(_weight(gen, d_in, d_out, dt, device, scale)))
        if cfg.qkv_bias:
            self.bq = _param(torch.zeros((h * hd,), dtype=dt, device=device))
            self.bk = _param(torch.zeros((kv * hd,), dtype=dt,
                                         device=device))
            self.bv = _param(torch.zeros((kv * hd,), dtype=dt,
                                         device=device))
        if cfg.qk_norm:
            self.q_norm = Norm(cfg.norm, hd, dt, device)
            self.k_norm = Norm(cfg.norm, hd, dt, device)


def _q(ctx: Ctx, cfg: ArchConfig, p: Attention, x: torch.Tensor):
    """The query projection of ``x`` (B, S, d): (B, S, H, hd)."""
    b, s, _ = x.shape
    q = linear(ctx, "attn/wq", x, p.wq, getattr(p, "bq", None))
    q = _whole_heads(q, cfg.n_heads).reshape(b, s, cfg.n_heads, cfg.hd)
    if cfg.qk_norm:
        q = norm_apply(cfg.norm, p.q_norm, q)
    return q


def _kv(ctx: Ctx, cfg: ArchConfig, p: Attention, x: torch.Tensor):
    """The key and value projections of ``x`` (B, S, d): (B, S, KV, hd)
    each; cross-attention projects the encoder's output with it."""
    b, s, _ = x.shape
    k = linear(ctx, "attn/wk", x, p.wk, getattr(p, "bk", None))
    v = linear(ctx, "attn/wv", x, p.wv, getattr(p, "bv", None))
    k = _whole_heads(k, cfg.n_kv_heads).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        k = norm_apply(cfg.norm, p.k_norm, k)
    v = _whole_heads(v, cfg.n_kv_heads)
    return k, v.reshape(b, s, cfg.n_kv_heads, cfg.hd)


def _whole_heads(t, n_heads: int):
    """A projection's output (B, S, heads · hd) whose last dim is sharded
    where ``n_heads`` does not divide by the mesh dim (the weight's
    columns shard by ``hd``-wide parts of a head): gathered over that
    mesh dim, so each rank holds whole heads.  Plain tensors pass."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    pls = [Replicate() if isinstance(p, Shard) and p.dim == t.ndim - 1
           and n_heads % t.device_mesh.size(i) else p
           for i, p in enumerate(t.placements)]
    return t.redistribute(t.device_mesh, pls)


def _qkv(ctx: Ctx, cfg: ArchConfig, p: Attention, x: torch.Tensor):
    return (_q(ctx, cfg, p, x), *_kv(ctx, cfg, p, x))


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,S,KV,hd) -> (B,S,H,hd) by group repetition."""
    g = n_heads // k.shape[2]
    return torch.repeat_interleave(k, g, dim=2) if g > 1 else k


def kv_positions_for_cache(pos, cache_len: int, sliding_window: int,
                           device=None) -> torch.Tensor:
    """Absolute position held by each decode-cache slot (2**30 = empty).

    Linear cache: slot i holds position i for i <= pos.  Sliding-window
    ring buffer: the current token lands at ``pos % cache_len`` and older
    slots wrap; slots that would map to negative positions were never
    written."""
    slot = torch.arange(cache_len, device=device)
    if sliding_window:
        idx = pos % cache_len
        kv_pos = torch.where(slot <= idx, pos - idx + slot,
                             pos - idx - cache_len + slot)
        return torch.where(kv_pos >= 0, kv_pos, EMPTY_POS)
    return torch.where(slot <= pos, slot, EMPTY_POS)


def decode_attention_mask(kv_pos: torch.Tensor, pos,
                          sliding_window: int) -> torch.Tensor:
    """(cache_len,) bool: which cache slots the token at ``pos`` attends."""
    mask = (kv_pos <= pos) & (kv_pos < EMPTY_POS)
    if sliding_window:
        mask &= (pos - kv_pos) < sliding_window
    return mask


def paged_kv_positions(seq_lens: torch.Tensor, n_slots: int) -> torch.Tensor:
    """(R, n_slots) absolute position held by each logical paged-cache slot.

    Slot ``i`` of request ``r`` holds position ``i`` when
    ``i <= seq_lens[r]`` (the slot at ``seq_lens[r]`` is the current
    token, written before attention) and is empty (2**30) past it.  The
    single source of truth for the paged decode mask that both the plain
    version and the CUDA kernel consume."""
    slot = torch.arange(n_slots, device=seq_lens.device)
    return torch.where(slot[None, :] <= seq_lens[:, None], slot[None, :],
                       EMPTY_POS)


def paged_decode_attention_mask(kv_pos: torch.Tensor,
                                seq_lens: torch.Tensor) -> torch.Tensor:
    """(R, n_slots) bool: slots each request's current token attends."""
    return (kv_pos <= seq_lens[:, None]) & (kv_pos < EMPTY_POS)


def ragged_prefill_positions(offsets: torch.Tensor, s: int) -> torch.Tensor:
    """(R, s) absolute position of each suffix query token: suffix token
    ``i`` of request ``r`` sits at ``offsets[r] + i`` (``offsets`` is the
    shared-prefix length)."""
    return offsets[:, None] + torch.arange(s, device=offsets.device)[None]


def ragged_prefill_attention_mask(offsets: torch.Tensor, lens: torch.Tensor,
                                  s: int, n_slots: int) -> torch.Tensor:
    """(R, s, n_slots) bool: paged-cache slots each suffix query attends.

    Query ``i`` at position ``offsets[r]+i`` attends every slot at or
    before it; rows at or past ``lens[r]`` (padding, idle slots) attend
    nothing.  The flash_prefill_ragged kernel derives the same predicate
    from ``offsets``/``lens`` itself."""
    q_pos = ragged_prefill_positions(offsets, s)
    valid_q = torch.arange(s, device=offsets.device)[None] < lens[:, None]
    slot = torch.arange(n_slots, device=offsets.device)
    return (slot[None, None, :] <= q_pos[:, :, None]) & valid_q[:, :, None]


def _masked_decode_attention(q, k, v, mask, n_heads: int) -> torch.Tensor:
    """One-token decode attention: the plain version's math.

    q: (B, 1, H, hd) over K/V (B, L, KV, hd); mask: (L,) batch-shared or
    (B, L) per-request.  fp32 inside, output in q's dtype."""
    hd = q.shape[-1]
    k_exp = _expand_kv(k, n_heads)
    v_exp = _expand_kv(v, n_heads)
    scale = 1.0 / math.sqrt(hd)
    sgl = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k_exp.float())
    m2 = mask if mask.ndim == 2 else mask[None]
    sgl = torch.where(m2[:, None, None, :], sgl, NEG_INF)
    w = torch.softmax(sgl, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v_exp.float()).to(q.dtype)


def mea_attention(q, k, v, q_positions, kv_positions, *,
                  causal: bool, window: int = 0, chunk: int = 1024,
                  bf16_operands: bool = False) -> torch.Tensor:
    """Chunked memory-efficient attention with online softmax.

    q: (B,Sq,H,hd); k/v: (B,Skv,H,hd) (kv already head-expanded);
    ``q_positions`` is (Sq,) batch-shared or (B, Sq) per-request.  Loops
    over kv chunks carrying (m, l, acc); with ``bf16_operands`` the
    products take bf16-rounded operands and still accumulate in fp32."""
    b, sq, h, hd = q.shape
    hd_v = v.shape[-1]
    skv = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    chunk = min(chunk, skv)
    op_dt = torch.bfloat16 if bf16_operands else torch.float32
    qf = (q.float() * scale).to(op_dt).float()
    qp = q_positions if q_positions.ndim == 2 else q_positions[None]

    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, hd_v), dtype=torch.float32, device=q.device)
    for c0 in range(0, skv, chunk):
        kj = k[:, c0:c0 + chunk].to(op_dt).float()
        vj = v[:, c0:c0 + chunk].to(op_dt).float()
        pj = kv_positions[c0:c0 + chunk]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kj)
        mask = (pj[None, None, :] < EMPTY_POS).expand(qp.shape[0], sq, -1)
        if causal:
            mask = mask & (qp[:, :, None] >= pj[None, None, :])
        if window:
            mask = mask & ((qp[:, :, None] - pj[None, None, :]) < window)
        s = torch.where(mask[:, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(op_dt).float(), vj)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                 # (B,Sq,H,hd)


def attention(ctx: Ctx, cfg: ArchConfig, p: Attention, x, positions,
              cache: dict | None = None, causal: bool = True,
              kv_override: tuple | None = None):
    """Full attention layer.  Returns (y, cache).

    - ``kv_override``: ``(k, v, kv_positions)``, cross-attention over K/V
      (B, F, KV, hd) the caller computed (the encoder's): never causal,
      never cached and never roped here, chunked MEA over K/V expanded
      to the H heads (the caller caches the encoder K/V);
    - ``cache is None``: chunked MEA over the sequence;
    - paged cache (``ctx.decode`` and ``"k_pages"`` in ``cache``): the
      ragged admission prefill when ``"prefill_lens"`` rides along, else
      one-token decode.  The page pools are updated in place;
    - contiguous cache (``{"k", "v", "pos"}``): with ``ctx.decode`` the
      tokens at ``pos`` attend the cache, else a prefill from position 0
      fills it.  ``k``/``v`` are updated in place and the returned dict
      carries the advanced ``pos``.

    ``positions``: (S,) or per-request (R, S) absolute query positions.
    """
    if ctx.mesh is not None and is_dtensor(x):
        return _mesh_attention(ctx, cfg, p, x, positions, cache, causal,
                               kv_override)
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    if kv_override is not None:
        # only q is projected: the reference's k/v of x are discarded
        k, v, kv_pos = kv_override
        out = mea_attention(_q(ctx, cfg, p, x), _expand_kv(k, h),
                            _expand_kv(v, h), positions, kv_pos, causal=False,
                            chunk=cfg.attn_chunk, bf16_operands=cfg.mea_bf16)
        return linear(ctx, "attn/wo", out.reshape(b, s, h * hd), p.wo), cache
    q, k, v = _qkv(ctx, cfg, p, x)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None and ctx.decode and "k_pages" in cache:
        if "prefill_lens" in cache:
            out = _paged_attention_prefill(cfg, q, k, v, cache)
        else:
            out = _paged_attention_decode(cfg, q, k, v, cache)
    elif cache is not None and ctx.decode:
        out, cache = _contiguous_attention_decode(cfg, q, k, v, cache)
    else:
        out = mea_attention(q, _expand_kv(k, h), _expand_kv(v, h),
                            positions, positions, causal=causal,
                            window=cfg.sliding_window, chunk=cfg.attn_chunk,
                            bf16_operands=cfg.mea_bf16)
        if cache is not None:
            cache = _fill_contiguous_cache(cfg, k, v, cache)
    y = linear(ctx, "attn/wo", out.reshape(b, s, h * hd), p.wo)
    return y, cache


# =====================================================================
# Attention on a device mesh
# =====================================================================
def seq_sharded(ctx: Ctx) -> bool:
    """The reference's guard: the mesh has a ``model`` axis wider than 1.
    The attention kernels take raw pointers and carry no sharding rule,
    so they run only where it is false; the plain attention runs
    otherwise (the reference keeps its jnp path there too)."""
    return (ctx.mesh is not None
            and axis_sizes(ctx.mesh).get("model", 1) > 1)


def _heads_placements(ctx: Ctx, cfg: ArchConfig, rows: int,
                      split: bool | None = None) -> tuple:
    """Placements of q/k/v (B, S, heads, hd) under which a rank's
    attention is exact: the ``rows`` batch rows over the data-parallel
    axes (where they divide), heads over ``model`` when both the query
    and the KV heads divide (each rank then holds whole GQA groups),
    else whole."""
    from torch.distributed.tensor import Shard
    m = axis_sizes(ctx.mesh).get("model", 1)
    if split is None:
        split = cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0
    return tuple(Shard(2) if a == "model" and split else p for a, p in
                 zip(ctx.mesh.mesh_dim_names,
                     batch_placements(ctx.mesh, rows=rows)))


def _local(ctx: Ctx, fn, placements: tuple, out: tuple, *args,
           grads: tuple | None = None):
    """``fn`` on each rank's local tensors (``local_map``): the args are
    first redistributed to ``placements`` (one per arg); the output takes
    ``out``; an arg's gradient leaves in ``grads``' placements (its own
    by default).  A kernel wrapper never sees a DTensor."""
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=list(out), in_placements=placements,
                     in_grad_placements=grads, device_mesh=ctx.mesh,
                     redistribute_inputs=True)(*args)


def _on_rows(ctx: Ctx, fn, weights: dict, x, state: dict | None = None):
    """``fn(w, x, state) -> (y, state)``, a function on plain tensors, on
    each rank's batch rows of the DTensor ``x`` (``local_map``): the
    DTensor ``weights`` (name → parameter) gathered whole and passed as a
    namespace ``w``; ``state`` (a layer's DTensor views into a stacked
    cache, or None) redistributed to the rank's rows, whole over the
    other axes.  ``fn`` writes the new state into those temporaries;
    they come back as outputs and each rank copies its shard into the
    cache in place, which keeps the rules' placements.  The weights'
    gradients leave partial over the axes that split the rows and reach
    their placements through DTensor.  Returns (y, state)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = ctx.mesh
    rows = batch_placements(mesh, rows=x.shape[0])
    whole = (Replicate(),) * mesh.ndim
    wgrad = tuple(Partial() if pl != Replicate() else pl for pl in rows)
    names = list(weights)
    keys = [] if state is None else list(state)

    def body(xl, *args):
        w = types.SimpleNamespace(**dict(zip(names, args[:len(names)])))
        ls = None if state is None else dict(zip(keys, args[len(names):]))
        y, ls = fn(w, xl, ls)
        return (y, *(ls[k] for k in keys))

    outs = local_map(
        body, out_placements=(rows,) * (1 + len(keys)),
        in_placements=(rows,) + (whole,) * len(names) + (rows,) * len(keys),
        in_grad_placements=(rows,) + (wgrad,) * len(names)
        + (rows,) * len(keys), device_mesh=mesh, redistribute_inputs=True)(
        x, *weights.values(), *(state[k] for k in keys))
    for k, t in zip(keys, outs[1:]):
        state[k].copy_(t.redistribute(mesh, state[k].placements))
    return outs[0], state


def _mesh_attention(ctx: Ctx, cfg: ArchConfig, p: Attention, x, positions,
                    cache, causal, kv_override=None):
    """:func:`attention` on DTensors: the projections are sharded products
    (``linear``), the attention itself runs on each rank's batch rows and
    heads (:func:`_heads_placements`, ``local_map``), and ``wo``'s
    row-parallel product sums the heads' parts.  The contiguous cache is
    a DTensor placed by the rules (``cache_shardings``); its sequence may
    be sharded over ``model`` (:func:`_mesh_decode`).  Cross-attention
    (``kv_override``, :func:`_mesh_cross`) attends DTensor K/V.  The
    paged cache serves on one device only."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
    if kv_override is not None:
        out = _mesh_cross(ctx, cfg, _q(ctx, cfg, p, x), kv_override,
                          positions)
        return linear(ctx, "attn/wo", out.reshape(b, s, h * hd), p.wo), cache
    pl = _heads_placements(ctx, cfg, b)
    if cache is not None and "k_pages" in cache:
        raise NotImplementedError("the paged cache serves on one device; "
                                  "a mesh takes the contiguous cache")
    q, k, v = _qkv(ctx, cfg, p, x)
    if cache is not None and ctx.decode:
        out, cache = _mesh_decode(ctx, cfg, q, k, v, cache, positions)
    else:
        def core(q, k, v, *kv_cache):
            if cfg.use_rope:
                q = apply_rope(q, positions, cfg.rope_theta)
                k = apply_rope(k, positions, cfg.rope_theta)
            # the heads a rank holds: q.shape[2], not cfg.n_heads
            o = mea_attention(q, _expand_kv(k, q.shape[2]),
                              _expand_kv(v, q.shape[2]), positions,
                              positions, causal=causal,
                              window=cfg.sliding_window,
                              chunk=cfg.attn_chunk,
                              bf16_operands=cfg.mea_bf16)
            if kv_cache:
                _fill_contiguous_cache(
                    cfg, k, v, dict(zip("kv", kv_cache)),
                    chunk=coord[:2] if coord else (0, 1))
            return o

        args, pls, coord = (q, k, v), (pl, pl, pl), None
        if cache is not None:
            cpl, qpl, coord = _cache_layout(ctx, cfg, cache["k"])
            args, pls = (q, k, v, cache["k"], cache["v"]), (qpl,) * 3 + (
                cpl, cpl)
            pl = qpl
        out = _local(ctx, core, pls, pl, *args)
        if cache is not None:
            cache = {"k": cache["k"], "v": cache["v"], "pos": s}
    y = linear(ctx, "attn/wo", out.reshape(b, s, h * hd), p.wo)
    return y, cache


def _mesh_cross(ctx: Ctx, cfg: ArchConfig, q, kv_override, positions):
    """Cross-attention on DTensors: the DTensor K/V (B, F, KV, hd) of
    ``kv_override`` — the cache's ``cross_k``/``cross_v`` at the rules'
    placements (``frames`` whole; ``kv_heads`` over ``model`` where they
    divide), or the projection of the encoder's output — attended at
    their own placements, each rank on its batch rows and the matching
    query heads (:func:`_cache_layout`).  Never causal, never roped:
    chunked MEA over the frames, as off the mesh."""
    k, v, kv_pos = kv_override
    cpl, qpl, _ = _cache_layout(ctx, cfg, k)

    def cross(q, k, v):
        h = q.shape[2]                  # the heads this rank holds
        return mea_attention(q, _expand_kv(k, h), _expand_kv(v, h),
                             positions, kv_pos, causal=False,
                             chunk=cfg.attn_chunk, bf16_operands=cfg.mea_bf16)
    return _local(ctx, cross, (qpl, cpl, cpl), qpl, q, k, v)


def _cache_layout(ctx: Ctx, cfg: ArchConfig, ck) -> tuple:
    """(the cache's placements, the q/k/v placements that match them,
    (this rank's sequence chunk, the chunks) or None): the cache's
    batch rows and, over ``model``, its KV heads (q's heads follow) or
    its sequence (q, k, v whole there)."""
    from torch.distributed.tensor import Shard
    cpl = tuple(ck.placements)
    names = ctx.mesh.mesh_dim_names
    heads = any(isinstance(p, Shard) and p.dim == 2 for p in cpl)
    qpl = _heads_placements(ctx, cfg, ck.shape[0], split=heads)
    seq = [i for i, p in enumerate(cpl) if isinstance(p, Shard)
           and p.dim == 1 and ctx.mesh.size(i) > 1]
    if len(seq) > 1:
        raise NotImplementedError("a cache sequence over two mesh axes")
    coord = None
    if seq:
        i = seq[0]
        coord = (ctx.mesh.get_coordinate()[i], ctx.mesh.size(i),
                 ctx.mesh.get_group(names[i]))
    # the batch rows must sit where q's do
    for a, p, want in zip(names, cpl, qpl):
        if a in DP_AXES and p != want:
            raise NotImplementedError(f"cache placement {cpl} does not keep "
                                      f"the batch over {a}")
    return cpl, qpl, coord


def _mesh_decode(ctx: Ctx, cfg: ArchConfig, q, k, v, cache, positions):
    """Cached decode of ``s`` tokens on a mesh, each rank on its batch
    rows.  A cache whole over ``model`` (or split by KV heads) runs
    :func:`_contiguous_attention_decode` on the rank's rows and heads —
    flash_decode where the mesh has no ``model`` axis wider than 1
    (:func:`seq_sharded`), the plain masked attention otherwise.  A cache
    whose sequence is sharded over ``model`` holds ``cache_len / m``
    slots a rank: the token is written by the rank that holds its slot,
    each rank takes the softmax's max, sum and weighted values over its
    slots, and an all-reduce of the three over ``model`` combines them
    (flash-decoding across ranks)."""
    cpl, qpl, coord = _cache_layout(ctx, cfg, cache["k"])
    pos = int(cache["pos"])
    plain = seq_sharded(ctx)

    def rope(q, k):
        if cfg.use_rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        return q, k

    def whole(q, k, v, ck, cv):
        return _contiguous_attention_decode(
            cfg, *rope(q, k), v, {"k": ck, "v": cv, "pos": pos},
            kernel=not plain)[0]

    def split(q, k, v, ck, cv):
        return _seq_split_decode(cfg, *rope(q, k), v, ck, cv, pos, coord)

    out = _local(ctx, split if coord else whole, (qpl,) * 3 + (cpl, cpl),
                 qpl, q, k, v, cache["k"], cache["v"])
    return out, {"k": cache["k"], "v": cache["v"], "pos": pos + q.shape[1]}


def _seq_split_decode(cfg: ArchConfig, q, k, v, ck, cv, pos: int, coord):
    """One rank's part of :func:`_mesh_decode` over a sequence-sharded
    cache: (r, m, group) = this rank's chunk, the chunks and the ``model``
    process group.  fp32 inside, out in q's dtype."""
    r, m, group = coord
    s = q.shape[1]
    local_len = ck.shape[1]
    lo = r * local_len
    start, mask = _decode_slots(cfg, pos, s, local_len * m, ck.device)
    for j in range(s):                    # the rows this rank holds
        if lo <= start + j < lo + local_len:
            ck[:, start + j - lo] = k[:, j].to(ck.dtype)
            cv[:, start + j - lo] = v[:, j].to(cv.dtype)
    mask = mask[lo:lo + local_len]
    h = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    sgl = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale,
                       _expand_kv(ck, h).float())
    sgl = torch.where(mask[None, None, None, :], sgl, NEG_INF)
    return _softmax_over_ranks(sgl, _expand_kv(cv, h), group, q.dtype)


def _softmax_over_ranks(sgl, v, group, dtype):
    """``softmax(sgl) @ v`` over the slots of every rank of ``group``, each
    holding its own: the max, the sum and the weighted values of each
    rank's slots all-reduced (flash-decoding across ranks).  ``sgl`` (B,
    H, S, K) fp32 and masked, ``v`` (B, K, H, D); out (B, S, H, D) in
    ``dtype``."""
    from torch.distributed import _functional_collectives as funcol
    mx = funcol.all_reduce(sgl.amax(dim=-1), "max", group)
    w = torch.exp(sgl - mx[..., None])
    den = funcol.all_reduce(w.sum(dim=-1), "sum", group)
    num = funcol.all_reduce(torch.einsum("bhqk,bkhd->bqhd", w, v.float()),
                            "sum", group)
    return (num / den.transpose(1, 2)[..., None]).to(dtype)


def cache_len_for(cfg: ArchConfig, seq_len: int) -> int:
    """Slots of a contiguous cache for ``seq_len`` tokens: all of them, or
    the window under a sliding window (the ring buffer)."""
    return seq_len if not cfg.sliding_window else min(seq_len,
                                                      cfg.sliding_window)


# the logical axes of one layer's contiguous cache (the JAX package's)
ATTN_CACHE_AXES = {"k": ("batch", "cache_seq", "kv_heads", "head_dim"),
                   "v": ("batch", "cache_seq", "kv_heads", "head_dim"),
                   "pos": ()}


def init_attention_cache(cfg: ArchConfig, batch: int, seq_len: int,
                         dtype=torch.bfloat16, device=None) -> dict:
    """One layer's contiguous decode cache: ``k``/``v`` (B, cache_len, KV,
    hd) zeros and ``pos`` 0 (``cache_len`` from :func:`cache_len_for`).
    ``pos`` is a host integer: the write slot and the decode mask derive
    from it without a device round trip."""
    shape = (batch, cache_len_for(cfg, seq_len), cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": 0}


def _decode_slots(cfg: ArchConfig, pos: int, s: int, cache_len: int,
                  device) -> tuple:
    """(start, mask) of ``s`` new tokens at ``pos`` in a cache of
    ``cache_len`` slots: the first slot they are written at — ``pos``
    (``pos % cache_len`` in the ring), clamped so the ``s`` rows fit, as
    the JAX package's ``dynamic_update_slice`` clamps — and the
    batch-shared mask over every slot from :func:`kv_positions_for_cache`
    / :func:`decode_attention_mask`."""
    idx = pos % cache_len if cfg.sliding_window else pos
    kv_pos = kv_positions_for_cache(pos, cache_len, cfg.sliding_window,
                                    device=device)
    return (min(max(idx, 0), cache_len - s),
            decode_attention_mask(kv_pos, pos, cfg.sliding_window))


def _contiguous_attention_decode(cfg: ArchConfig, q, k, v, cache,
                                 kernel: bool = True):
    """Cached attention of ``s`` new tokens at ``cache["pos"]``.

    q/k/v: (B, s, ·, hd), already roped at ``pos + i``; the heads are
    q's (a rank's part on a mesh).  The new K/V is written in place
    from :func:`_decode_slots`' start; then every query attends the
    cache under its mask — through flash_decode for one token (with
    ``kernel``), through the plain masked attention for ``s > 1`` (the
    kernel is single-token, as the JAX package's is) or without
    ``kernel``.  The write precedes the kernel's read on the same
    stream.  Returns (out, cache with ``pos + s``)."""
    from repro_torch.kernels.flash_decode import flash_decode
    ck, cv = cache["k"], cache["v"]
    pos = int(cache["pos"])
    s = q.shape[1]
    start, mask = _decode_slots(cfg, pos, s, ck.shape[1], ck.device)
    ck[:, start:start + s] = k.to(ck.dtype)
    cv[:, start:start + s] = v.to(cv.dtype)
    if s == 1 and kernel:
        out = flash_decode(q.contiguous(), ck, cv, mask)
    else:
        out = _masked_decode_attention(q, ck, cv, mask, q.shape[2])
    return out, {"k": ck, "v": cv, "pos": pos + s}


def _fill_contiguous_cache(cfg: ArchConfig, k, v, cache,
                           chunk: tuple = (0, 1)):
    """Prefill of ``s`` tokens from position 0: the last ``cache_len`` of
    them go into the cache in place, rotated under a sliding window so
    position ``p`` sits at slot ``p % cache_len`` (the layout decode's
    :func:`kv_positions_for_cache` recovers).  With ``chunk`` = (r, m)
    the cache holds the r-th of m equal chunks of the slots (a rank's
    part of a sequence-sharded cache) and only those are written.
    Returns the cache with ``pos = s``."""
    ck, cv = cache["k"], cache["v"]
    s = k.shape[1]
    r, m = chunk
    rows = ck.shape[1]
    cache_len = rows * m
    kk, vv = (k, v) if s <= cache_len else (k[:, -cache_len:],
                                            v[:, -cache_len:])
    if cfg.sliding_window and s > cache_len:
        shift = s % cache_len
        kk = torch.roll(kk, shift, dims=1)
        vv = torch.roll(vv, shift, dims=1)
    lo = r * rows
    hi = min(lo + rows, kk.shape[1])
    if hi > lo:
        ck[:, :hi - lo] = kk[:, lo:hi].to(ck.dtype)
        cv[:, :hi - lo] = vv[:, lo:hi].to(cv.dtype)
    return {"k": ck, "v": cv, "pos": s}


def _paged_attention_decode(cfg: ArchConfig, q, k, v, cache):
    """One-token attention over a paged block-table cache (ragged batch).

    q/k/v: (R, 1, ·, hd), already roped at per-request positions.  The
    per-layer cache carries this layer's page pools (``k_pages`` /
    ``v_pages``: (P, page_size, KV, hd) views into the model's stacked
    pool) plus the batch-shared ``block_tables`` (R, M) and ``seq_lens``
    (R,).  The current token's K/V is written into page
    ``block_tables[r, seq_lens[r] // ps]`` — in place: the JAX package
    donates the pool and rebuilds it, here the write lands in the stacked
    tensor through the view — and then each request attends its own
    prefix through flash_decode_paged, under the mask built by
    :func:`paged_kv_positions` / :func:`paged_decode_attention_mask`.
    The write precedes the kernel's read on the same stream.
    """
    if cfg.sliding_window:
        raise ValueError("paged decode supports linear caches only")
    from repro_torch.kernels.flash_decode_paged import flash_decode_paged
    kp, vp = cache["k_pages"], cache["v_pages"]
    bt, sl = cache["block_tables"], cache["seq_lens"]
    ps = kp.shape[1]
    r = q.shape[0]
    n_slots = bt.shape[1] * ps
    # the clamp only ever bites for slots the engine parked on its
    # scratch page (capacity for live requests is sized at admission)
    pos_w = torch.clamp(sl, max=n_slots - 1).long()
    pidx = bt[torch.arange(r, device=bt.device), pos_w // ps].long()
    slot = pos_w % ps
    kp[pidx, slot] = k[:, 0].to(kp.dtype)
    vp[pidx, slot] = v[:, 0].to(vp.dtype)
    mask = paged_decode_attention_mask(paged_kv_positions(sl, n_slots), sl)
    return flash_decode_paged(q, kp, vp, bt, mask)


def _paged_attention_prefill(cfg: ArchConfig, q, k, v, cache):
    """Batched ragged admission prefill over a paged block-table cache.

    q/k/v: (R, S, ·, hd), each row one admission's suffix, roped at
    ``seq_lens[r] + i`` (``seq_lens`` carries the shared-prefix offsets
    during an admission dispatch; ``prefill_lens`` the valid suffix
    lengths, 0 for idle rows).  The suffix K/V is written into each
    request's own pages first — in place, as in the decode branch;
    padding and idle rows land on the scratch page 0 — and then every
    suffix query attends causally over its full logical prefix through
    flash_prefill_ragged, at the ``block_q`` TUNE left in the default
    autotune cache for this dispatch shape (the kernel default on a miss;
    read once per shape, :func:`autotune.memo_tile_readback`).
    """
    if cfg.sliding_window:
        raise ValueError("paged prefill supports linear caches only")
    from repro_torch.kernels import autotune
    from repro_torch.kernels.flash_prefill_ragged import flash_prefill_ragged
    kp, vp = cache["k_pages"], cache["v_pages"]
    bt, off = cache["block_tables"], cache["seq_lens"]
    lens = cache["prefill_lens"]
    _, ps, kvh, hd = kp.shape
    r, s, h, _ = q.shape
    n_slots = bt.shape[1] * ps
    pos = ragged_prefill_positions(off, s)
    valid = torch.arange(s, device=q.device)[None] < lens[:, None]
    pos_c = torch.clamp(pos, max=n_slots - 1).long()
    rows = torch.arange(r, device=q.device)[:, None]
    pidx = torch.where(valid, bt[rows, pos_c // ps], 0).long()
    slot = pos_c % ps
    kp[pidx, slot] = k.to(kp.dtype)
    vp[pidx, slot] = v.to(vp.dtype)
    tile, _ = autotune.memo_tile_readback(
        "flash_prefill_ragged",
        autotune.flash_prefill_ragged_problem(r, s, h, kvh, hd, n_slots, ps,
                                              q.dtype), device=q.device)
    return flash_prefill_ragged(q, kp, vp, bt, off, lens,
                                block_q=tile["block_q"])


# =====================================================================
# MLA (DeepSeek-V2 multi-head latent attention)
# =====================================================================
class MLA(nn.Module):
    """MLA parameters, named as the JAX package's ``init_mla``: the query
    path ``wq_a`` → ``q_a_norm`` → ``wq_b`` (or ``wq`` when
    ``q_lora_rank`` is 0), the compressed K/V path ``wkv_a`` (to
    ``kv_lora_rank + rope_head_dim``) → ``kv_a_norm``, its expansion
    ``wkv_b`` (to the heads' nope keys and values) and ``wo``."""

    AXES = {"wq_a": ("embed", "q_lora"), "wq_b": ("q_lora", "heads"),
            "q_a_norm": "q_lora", "wq": ("embed", "heads"),
            "wkv_a": ("embed", "kv_lora"), "kv_a_norm": "kv_lora",
            "wkv_b": ("kv_lora", "heads"), "wo": ("heads", "embed")}

    def __init__(self, cfg: ArchConfig, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        qd = cfg.nope_head_dim + cfg.rope_head_dim
        dt = cfg.pdt
        shapes = ({"wq_a": (d, cfg.q_lora_rank),
                   "wq_b": (cfg.q_lora_rank, h * qd)} if cfg.q_lora_rank
                  else {"wq": (d, h * qd)})
        shapes.update(
            wkv_a=(d, cfg.kv_lora_rank + cfg.rope_head_dim),
            wkv_b=(cfg.kv_lora_rank,
                   h * (cfg.nope_head_dim + cfg.v_head_dim)),
            wo=(h * cfg.v_head_dim, d))
        for name, (d_in, d_out) in shapes.items():
            setattr(self, name, _param(_weight(gen, d_in, d_out, dt, device)))
        if cfg.q_lora_rank:
            self.q_a_norm = Norm(cfg.norm, cfg.q_lora_rank, dt, device)
        self.kv_a_norm = Norm(cfg.norm, cfg.kv_lora_rank, dt, device)


def mla_attention(ctx: Ctx, cfg: ArchConfig, p: MLA, x, positions,
                  cache: dict | None = None):
    """MLA with the compressed cache (``ckv`` and ``krope`` only), as the
    JAX package's ``mla_attention``.  Returns (y, cache).

    - ``cache is None``: chunked MEA over the sequence;
    - ``ctx.decode``: the new tokens' ``ckv``/``krope`` are written in
      place at ``pos`` (the start clamped as ``dynamic_update_slice``
      clamps it) and the queries attend every slot ``<= pos`` of the
      whole cache in fp32 — for one token the causal mask; for S > 1 the
      new tokens do not see one another, as in the reference;
    - otherwise a prefill from position 0 that also fills the cache.

    The nope keys and the values are recomputed from the compressed
    cache at attention time (fp32 products with ``wkv_b``, as the
    reference's einsums); q and k are ``nope + rope`` wide, v
    ``v_head_dim``.  ``wkv_b`` is no ``linear`` call, so no policy
    reaches it.  On a mesh the projections are sharded products and the
    rest runs on each rank's batch rows and heads (:func:`_mesh_mla`)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    nd, rd, vd = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    kvl = cfg.kv_lora_rank
    if cfg.q_lora_rank:
        qa = linear(ctx, "attn/wq_a", x, p.wq_a)
        qa = norm_apply(cfg.norm, p.q_a_norm, qa)
        q = linear(ctx, "attn/wq_b", qa, p.wq_b)
    else:
        q = linear(ctx, "attn/wq", x, p.wq)
    q = _whole_heads(q, h).reshape(b, s, h, nd + rd)
    kv_a = linear(ctx, "attn/wkv_a", x, p.wkv_a)
    ckv = norm_apply(cfg.norm, p.kv_a_norm, kv_a[..., :kvl])
    kr = kv_a[..., kvl:]
    decode = cache is not None and ctx.decode
    if ctx.mesh is not None and is_dtensor(x):
        out, cache = _mesh_mla(ctx, cfg, q, ckv, kr, p.wkv_b, positions,
                               cache, decode)
    else:
        out, cache = _mla_core(cfg, q, ckv, kr, p.wkv_b, positions, cache,
                               decode)
    y = linear(ctx, "attn/wo", out.reshape(b, s, h * vd), p.wo)
    return y, cache


def _mla_rope(cfg: ArchConfig, q, kr, positions):
    """(q with its rope part rotated, the rotated rope key (B, S, rd))."""
    nd = cfg.nope_head_dim
    q_rope = apply_rope(q[..., nd:], positions, cfg.rope_theta)
    k_rope = apply_rope(kr[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return torch.cat([q[..., :nd], q_rope], dim=-1), k_rope


def _mla_kv(cfg: ArchConfig, ckv, krope, wkv_b, dtype):
    """The heads' keys (nope + rope) and values from the compressed
    cache: fp32 products with ``wkv_b`` (its columns: the heads'), cast
    to ``dtype``."""
    nd, vd = cfg.nope_head_dim, cfg.v_head_dim
    wkv = wkv_b.float().reshape(cfg.kv_lora_rank, -1, nd + vd)
    h = wkv.shape[1]
    cf = ckv.float()
    k_nope = torch.einsum("bsc,chd->bshd", cf, wkv[..., :nd])
    v = torch.einsum("bsc,chd->bshd", cf, wkv[..., nd:]).to(dtype)
    k = torch.cat([k_nope.to(dtype),
                   krope[:, :, None, :].expand(-1, -1, h, -1).to(dtype)],
                  dim=-1)
    return k, v


def _mla_core(cfg: ArchConfig, q, ckv, kr, wkv_b, positions, cache, decode,
              chunk: int = 0):
    """MLA after its projections: q (B, S, h, nd + rd) for h heads (a
    rank's on a mesh, ``wkv_b`` those heads' columns), the normed ``ckv``
    and the unrotated rope key ``kr`` (B, S, rd).  A prefill's cache
    holds the ``chunk``-th of equal chunks of the sequence (a rank's
    part of a sequence-sharded cache) and only those rows are written.
    Returns (out (B, S, h, vd), cache)."""
    s = q.shape[1]
    qfull, k_rope = _mla_rope(cfg, q, kr, positions)
    if decode:
        ckv_use, kr_use = cache["ckv"], cache["krope"]
        pos = int(cache["pos"])
        start = min(max(pos, 0), ckv_use.shape[1] - s)
        ckv_use[:, start:start + s] = ckv.to(ckv_use.dtype)
        kr_use[:, start:start + s] = k_rope.to(kr_use.dtype)
        valid = torch.arange(ckv_use.shape[1], device=q.device) <= pos
        cache = {"ckv": ckv_use, "krope": kr_use, "pos": pos + s}
    else:
        ckv_use, kr_use = ckv, k_rope
        if cache is not None:
            rows = cache["ckv"].shape[1]
            lo, hi = chunk * rows, min((chunk + 1) * rows, s)
            if hi > lo:
                cache["ckv"][:, :hi - lo] = ckv[:, lo:hi].to(
                    cache["ckv"].dtype)
                cache["krope"][:, :hi - lo] = k_rope[:, lo:hi].to(
                    cache["krope"].dtype)
            cache = {"ckv": cache["ckv"], "krope": cache["krope"], "pos": s}
    k, v = _mla_kv(cfg, ckv_use, kr_use, wkv_b, q.dtype)
    if decode:
        scale = 1.0 / math.sqrt(qfull.shape[-1])
        sgl = torch.einsum("bqhd,bkhd->bhqk", qfull.float() * scale,
                           k.float())
        sgl = torch.where(valid[None, None, None, :], sgl, NEG_INF)
        w = torch.softmax(sgl, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)
    else:
        out = mea_attention(qfull, k, v, positions, positions, causal=True,
                            chunk=cfg.attn_chunk, bf16_operands=cfg.mea_bf16)
    return out, cache


def _mesh_mla(ctx: Ctx, cfg: ArchConfig, q, ckv, kr, wkv_b, positions,
              cache, decode):
    """:func:`_mla_core` on DTensors, each rank on its batch rows and, where
    they divide over ``model``, its heads (and ``wkv_b``'s columns of
    them); the compressed K/V whole over ``model``.  The compressed cache
    is placed by the rules (``cache_seq`` → ``model`` by default): a
    prefill writes each rank's sequence chunk; a decode over a cache
    whose sequence is sharded over ``model`` runs :func:`_mla_split_decode`
    with every head on every rank, the softmax combined across ranks.
    The gradients of the parts every head's rank reads (``ckv``, the
    rope key) are partial over ``model``, ``wkv_b``'s over the batch
    axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    names = ctx.mesh.mesh_dim_names
    b = q.shape[0]
    coord = None
    if cache is not None:       # (the cache has no heads: only cpl, coord)
        cpl, _, coord = _cache_layout(ctx, cfg, cache["ckv"])
    qpl = _heads_placements(ctx, cfg, b,
                            split=False if decode and coord else None)
    rows = batch_placements(ctx.mesh, rows=b)
    heads = [isinstance(pl, Shard) and pl.dim == 2 for pl in qpl]
    wpl = tuple(Shard(1) if hs else Replicate() for hs in heads)
    wgrad = tuple(Partial() if a in DP_AXES and pl != Replicate() else w
                  for a, pl, w in zip(names, rows, wpl))
    kvgrad = tuple(Partial() if hs else pl for hs, pl in zip(heads, rows))
    args = [q, ckv, kr, wkv_b]
    pls, grads = [qpl, rows, rows, wpl], [qpl, kvgrad, kvgrad, wgrad]
    if cache is not None:
        args += [cache["ckv"], cache["krope"]]
        pls += [cpl, cpl]
        grads += [cpl, cpl]
    pos = None if cache is None else int(cache["pos"])

    def core(q, ckv, kr, wkv_b, *kv_cache):
        lc = None if not kv_cache else {"ckv": kv_cache[0],
                                        "krope": kv_cache[1], "pos": pos}
        if decode and coord:
            return _mla_split_decode(cfg, q, ckv, kr, wkv_b, positions, lc,
                                     coord)
        return _mla_core(cfg, q, ckv, kr, wkv_b, positions, lc, decode,
                         chunk=coord[0] if coord else 0)[0]

    out = _local(ctx, core, tuple(pls), qpl, *args, grads=tuple(grads))
    if cache is not None:
        s = q.shape[1]
        cache = {"ckv": cache["ckv"], "krope": cache["krope"],
                 "pos": pos + s if decode else s}
    return out, cache


def _mla_split_decode(cfg: ArchConfig, q, ckv, kr, wkv_b, positions, cache,
                      coord):
    """One rank's MLA decode over a sequence-sharded compressed cache
    (``cache_len / m`` slots a rank; (r, m, group) = this rank's chunk,
    the chunks and the ``model`` group): the new tokens are written by
    the rank that holds their slots, each rank takes the softmax's max,
    sum and weighted values over its valid slots (``<= pos``) for every
    head, and an all-reduce of the three combines them.  fp32 inside,
    out in q's dtype."""
    r, m, group = coord
    ck, ckr = cache["ckv"], cache["krope"]
    pos = cache["pos"]
    s = q.shape[1]
    qfull, k_rope = _mla_rope(cfg, q, kr, positions)
    local_len = ck.shape[1]
    lo = r * local_len
    start = min(max(pos, 0), local_len * m - s)
    for j in range(s):                    # the rows this rank holds
        if lo <= start + j < lo + local_len:
            ck[:, start + j - lo] = ckv[:, j].to(ck.dtype)
            ckr[:, start + j - lo] = k_rope[:, j].to(ckr.dtype)
    valid = torch.arange(lo, lo + local_len, device=q.device) <= pos
    k, v = _mla_kv(cfg, ck, ckr, wkv_b, q.dtype)
    scale = 1.0 / math.sqrt(qfull.shape[-1])
    sgl = torch.einsum("bqhd,bkhd->bhqk", qfull.float() * scale, k.float())
    sgl = torch.where(valid[None, None, None, :], sgl, NEG_INF)
    return _softmax_over_ranks(sgl, v, group, q.dtype)


MLA_CACHE_AXES = {"ckv": ("batch", "cache_seq", "kv_lora"),
                  "krope": ("batch", "cache_seq", None), "pos": ()}


def init_mla_cache(cfg: ArchConfig, batch: int, seq_len: int,
                   dtype=torch.bfloat16, device=None) -> dict:
    """One layer's compressed decode cache: ``ckv`` (B, seq_len,
    kv_lora_rank) and ``krope`` (B, seq_len, rope_head_dim) zeros, ``pos``
    0 (a host integer, as the dense cache's)."""
    return {"ckv": torch.zeros((batch, seq_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "krope": torch.zeros((batch, seq_len, cfg.rope_head_dim),
                                 dtype=dtype, device=device),
            "pos": 0}


# =====================================================================
# Dense MLPs
# =====================================================================
class MLP(nn.Module):
    """GLU (``w_gate``, ``w_up``, ``w_down``) or GELU MLP (``w_up``,
    ``w_down`` and optional biases) parameters, stored ``(in, out)``, of
    width ``d_ff`` (``cfg.d_ff`` by default); drawn from ``gen`` as the JAX
    package's ``init_mlp`` draws them, or left uninitialised without
    one."""

    AXES = {"w_gate": ("embed", "ffn"), "w_up": ("embed", "ffn"),
            "w_down": ("ffn", "embed"), "b_up": ("ffn",),
            "b_down": ("embed",)}

    def __init__(self, cfg: ArchConfig, device=None,
                 gen: torch.Generator | None = None,
                 d_ff: int | None = None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff if d_ff is None else d_ff
        dt = cfg.pdt
        names = ["w_gate", "w_up", "w_down"] if cfg.mlp == "glu" \
            else ["w_up", "w_down"]
        for name in names:
            d_in, d_out = (f, d) if name == "w_down" else (d, f)
            scale = 1.0 / math.sqrt(f) if name == "w_down" else None
            setattr(self, name,
                    _param(_weight(gen, d_in, d_out, dt, device, scale)))
        if cfg.mlp != "glu" and cfg.mlp_bias:
            self.b_up = _param(torch.zeros((f,), dtype=dt, device=device))
            self.b_down = _param(torch.zeros((d,), dtype=dt, device=device))


def mlp(ctx: Ctx, cfg: ArchConfig, p: MLP, x):
    if cfg.mlp == "glu":
        g = linear(ctx, "mlp/w_gate", x, p.w_gate)
        u = linear(ctx, "mlp/w_up", x, p.w_up)
        h = act_fn("silu")(g.float()).to(x.dtype) * u
        return linear(ctx, "mlp/w_down", h, p.w_down)
    u = linear(ctx, "mlp/w_up", x, p.w_up, getattr(p, "b_up", None))
    h = act_fn("gelu")(u.float()).to(x.dtype)
    return linear(ctx, "mlp/w_down", h, p.w_down, getattr(p, "b_down", None))


# =====================================================================
# Mixture of Experts
# =====================================================================
# On the card the number of rows routed to an expert depends on the other
# requests in the batch, and cuBLAS picks a product's algorithm by its row
# count: a token's bits would move with its neighbours, and the recovery
# lanes rest on bit-identical greedy tokens.  So every expert product on
# the card runs in blocks of MOE_ROW_BLOCK rows, each expert's rows padded
# with zero rows to a whole number of blocks, in prefill and decode alike.
MOE_ROW_BLOCK = 64
# .tolist() reads of the expert counts, one per MoE layer call
moe_host_syncs = 0


class MoE(nn.Module):
    """MoE parameters, named as the JAX package's ``init_moe``: ``router``
    (d, E) in fp32 whatever the parameter dtype, the stacked experts
    ``w_gate``/``w_up`` (E, d, f) and ``w_down`` (E, f, d), and with shared
    experts ``shared``, a GLU :class:`MLP` of width ``d_expert ×
    n_shared_experts``."""

    AXES = {"router": ("embed", None),
            "w_gate": ("experts", "embed", "expert_ffn"),
            "w_up": ("experts", "embed", "expert_ffn"),
            "w_down": ("experts", "expert_ffn", "embed")}

    def __init__(self, cfg: ArchConfig, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_expert, cfg.n_experts
        self.router = _param(_weight(gen, d, e, torch.float32, device))
        for name, (d_in, d_out) in (("w_gate", (d, f)), ("w_up", (d, f)),
                                    ("w_down", (f, d))):
            w = torch.empty((e, d_in, d_out), dtype=cfg.pdt, device=device)
            if gen is not None:     # one expert at a time: no (E, d, f)
                scale = 1.0 / math.sqrt(f) if name == "w_down" else None
                for i in range(e):  # fp32 temporary
                    w[i] = dense_init(gen, d_in, d_out, cfg.pdt, scale)
            setattr(self, name, _param(w))
        if cfg.n_shared_experts:
            self.shared = MLP(cfg.replace(mlp="glu"), device, gen,
                              d_ff=cfg.d_expert * cfg.n_shared_experts)


def _top_k(probs: torch.Tensor, k: int):
    """The ``k`` largest of each row, ties to the lower index first as
    ``jax.lax.top_k`` takes them (a stable descending sort; ``torch.topk``
    promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(cfg: ArchConfig, router_w, x):
    """Gates and expert indices (N, top_k) of the N tokens of ``x`` (...,
    d): fp32 logits, softmax, top-k, the gates renormalised by
    ``max(sum, 1e-9)``.  The logits are a row-invariant product (fixed
    row blocks on the card for more than one token a row)."""
    logits = row_invariant_matmul(x.float(), router_w.float())
    probs = torch.softmax(logits.reshape(-1, cfg.n_experts), dim=-1)
    gates, eidx = _top_k(probs, cfg.top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, eidx


def moe_ffn(ctx: Ctx, cfg: ArchConfig, p: MoE, x):
    """Top-k routed MoE, dispatched as the JAX package's ``moe_ffn``.

    - On a mesh (DTensors) with a ``model`` axis whose size divides the
      experts — a 1 x 1 mesh among them — the expert-parallel
      :func:`_moe_ep` (capacity, bf16 expert products), as the reference
      takes ``_moe_ep`` whenever its mesh has that axis; on any other
      mesh, where the reference runs ``_moe_dense_reference`` on the
      mesh, :func:`_moe_routed` on each rank's batch rows over the
      experts gathered whole (:func:`_on_rows`).
    - Off a mesh the reference's ``_moe_dense_reference`` multiplies
      every token through every expert in fp32 and weights the results
      by a combine matrix that is zero outside the token's top-k; here
      each token goes through its top-k experts only
      (:func:`_moe_routed`), which computes the same sum; like the
      reference's, these routed experts ignore the policy.  Inside
      :func:`plain_ep_routing` the plain expert-parallel function
      (:func:`moe_ffn_ep_plain`) takes their place.

    The shared experts are a GLU ``mlp`` (``mlp/…`` names, so a policy
    reaches them) added after the routed sum is cast to ``x.dtype``."""
    y_shared = 0.0
    if cfg.n_shared_experts:
        y_shared = mlp(ctx, cfg.replace(mlp="glu"), p.shared, x)
    if ctx.mesh is not None and is_dtensor(x):
        tp = axis_sizes(ctx.mesh).get("model")
        if tp is None or cfg.n_experts % tp:
            y, _ = _on_rows(ctx, lambda w, xl, _: (_moe_routed(
                cfg, w, xl, MOE_ROW_BLOCK if xl.is_cuda else None), None),
                {n: p.get_parameter(n) for n in
                 ("router", "w_gate", "w_up", "w_down")}, x)
        else:
            y = _moe_ep(ctx, cfg, p, x)
    elif _plain_ep is not None:
        y = moe_ffn_ep_plain(ctx, cfg, p, x, *_plain_ep)
    else:
        y = _moe_routed(cfg, p, x, MOE_ROW_BLOCK if x.is_cuda else None)
    return y + y_shared


def _moe_routed(cfg: ArchConfig, p: MoE, x, row_block: int | None):
    """``sum_k gate[n, k] * expert_{eidx[n, k]}(x_n)`` for every token, in
    fp32 (the products and SiLU), cast to ``x.dtype``.

    The (token, k) routings are sorted by expert (stably, so each expert
    takes its tokens in order) and gathered into one padded row layout:
    expert ``e``'s rows are a contiguous range, padded with zero rows to
    a multiple of ``row_block`` (no padding for ``None``).  Each expert
    multiplies its range ``row_block`` rows at a time (one product for
    ``None``); experts with no token are skipped.  The expert counts come
    back to the host in one read.  Each token's k outputs are then
    gathered back and summed in k order: no atomic scatter anywhere."""
    global moe_host_syncs
    e, k = cfg.n_experts, cfg.top_k
    b, s, d = x.shape
    dev = x.device
    gates, eidx = _router(cfg, p.router, x)
    n = gates.shape[0]
    sorted_ids, order = torch.sort(eidx.reshape(-1), stable=True)
    bounds = torch.searchsorted(sorted_ids, torch.arange(e + 1, device=dev))
    counts_d = bounds[1:] - bounds[:-1]
    bounds_h = bounds.tolist()                 # the layer's one host read
    moe_host_syncs += 1
    counts = [bounds_h[i + 1] - bounds_h[i] for i in range(e)]
    if row_block is None:
        padded, padded_d = counts, counts_d
    else:
        padded = [-(-c // row_block) * row_block for c in counts]
        padded_d = (counts_d + row_block - 1) // row_block * row_block
    pstart_d = torch.cumsum(padded_d, 0) - padded_d
    total = sum(padded)
    # padded row of each sorted routing, and the token row of each padded
    # row (``n``, one zero row past the tokens, for padding)
    dest = (torch.arange(n * k, device=dev)
            + (pstart_d - bounds[:-1])[sorted_ids])
    src = torch.full((total,), n, dtype=torch.long, device=dev)
    src[dest] = order // k
    xf = x.reshape(n, d).float()
    xg = torch.cat([xf, xf.new_zeros((1, d))])[src]

    wg, wu, wd = (w.unbind(0) for w in (p.w_gate, p.w_up, p.w_down))
    spans = []                                  # (expert, row0, row1)
    start = 0
    for i, rows in enumerate(padded):
        if rows:
            step = row_block or rows
            spans += [(i, a, a + step)
                      for a in range(start, start + rows, step)]
        start += rows
    g = torch.cat([xg[a:z] @ wg[i].float() for i, a, z in spans])
    u = torch.cat([xg[a:z] @ wu[i].float() for i, a, z in spans])
    hh = F.silu(g) * u
    yg = torch.cat([hh[a:z] @ wd[i].float() for i, a, z in spans])
    pos = torch.empty_like(dest)
    pos[order] = dest
    ye = yg[pos].reshape(n, k, d)
    y = ye[:, 0] * gates[:, :1]
    for j in range(1, k):
        y = y + ye[:, j] * gates[:, j:j + 1]
    return y.reshape(b, s, d).to(x.dtype)


# ------------------------------------------------- expert parallelism
def _rank_in_expert(ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Position of each routing within its expert's queue, in routing
    order: a stable sort of the expert ids, each expert's first place in
    it, and the inverse permutation — the JAX package's
    ``_rank_in_expert``, integer work only.  No value is read back to the
    host."""
    nk = ids.shape[0]
    sorted_ids, sort_idx = torch.sort(ids, stable=True)
    starts = torch.searchsorted(sorted_ids,
                                torch.arange(n_experts, device=ids.device))
    pos = torch.empty_like(sort_idx)
    pos[sort_idx] = torch.arange(nk, device=ids.device) - starts[sorted_ids]
    return pos


def _expert_ffn(ctx: Ctx, recv, wg, wu, wd):
    """(E, C, d) tokens through each expert's GLU, ``wg``/``wu`` (E, d, f)
    and ``wd`` (E, f, d): bf16 operands with fp32 products (the
    reference's ``preferred_element_type=float32`` einsums: the
    bf16-rounded operands multiplied in fp32), SiLU in fp32, the hidden
    rounded to bf16, the output cast to ``recv``'s dtype.

    Under the INT8 ``moe/experts`` level each expert is quantized per
    output channel: decode multiplies the dequantized values (the
    reference's comment names a Pallas kernel its code does not call);
    training is straight-through (the quantized forward, the
    full-precision gradient).  These are plain products outside any
    kernel, in the JAX package too."""
    if ctx.level_for("moe/experts") == INT8:
        def q3(w):
            qw, sc = quantize_int8(w, axis=1)
            deq = qw.float() * sc
            if ctx.decode:
                return deq
            wf = w.float()
            return wf + (deq - wf).detach()
        wg, wu, wd = q3(wg), q3(wu), q3(wd)

    def bf(t):
        return t.to(torch.bfloat16).float()
    rg, ru = _Bf16Pair.apply(recv)
    g = torch.bmm(rg, bf(wg))
    u = torch.bmm(ru, bf(wu))
    h = bf(F.silu(g) * u)
    return torch.bmm(h, bf(wd)).to(recv.dtype)


class _Bf16Pair(torch.autograd.Function):
    """``x`` rounded to bf16, as fp32, for two products: the reference
    reads one bf16 value twice, so the two products' gradients are each
    rounded to bf16 and added in bf16 before they reach ``x`` (rounding
    their fp32 sum once instead moves a bf16 step)."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        r = x.to(torch.bfloat16).float()
        return r, r.clone()

    @staticmethod
    def backward(ctx, g1, g2):
        gs = [g.to(torch.bfloat16) for g in (g1, g2) if g is not None]
        g = gs[0] if len(gs) == 1 else gs[0] + gs[1]
        return g.to(ctx.dtype)


def _ep_capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Slots an expert keeps for ``n_tokens`` routed tokens."""
    return max(8, int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                                / cfg.n_experts)))


def _ep_dispatch(cfg: ArchConfig, router_w, x2, e_lo: int, e_n: int):
    """Route the n tokens of ``x2`` (n, d) and lay the routings to experts
    ``[e_lo, e_lo + e_n)`` out by expert under the capacity of n tokens.

    Returns (the (e_n · cap, d) dispatch buffer — row ``(e - e_lo) · cap
    + q`` holds the q-th token routed to expert e, zeros where none —,
    each routing's slot (``e_n · cap`` when dropped), each routing's gate
    (0 when dropped), cap).  The buffer is gathered through the inverse
    of the slot map: every dropped routing points at the one trash slot,
    which is cut off, so no live row is written twice (the reference
    scatters with ``.at[slot].set``)."""
    e, k = cfg.n_experts, cfg.top_k
    n, d = x2.shape
    gates, eidx = _router(cfg, router_w, x2)
    ids = eidx.reshape(-1)
    cap = _ep_capacity(cfg, n)
    pos = _rank_in_expert(ids, e)
    keep = pos < cap
    if e_n < e:
        keep = keep & (ids >= e_lo) & (ids < e_lo + e_n)
    slot = torch.where(keep, (ids - e_lo) * cap + pos, e_n * cap)
    inv = torch.full((e_n * cap + 1,), n * k, dtype=torch.long,
                     device=x2.device)
    inv[slot] = torch.arange(n * k, device=x2.device)
    xz = torch.cat([x2, x2.new_zeros((1, d))])
    disp = xz[inv[:e_n * cap] // k]      # a free slot reads the zero row
    return disp, slot, gates.reshape(-1) * keep, cap


def _ep_combine(y, slot, wgt, k: int, dtype):
    """Each token's k expert outputs (rows ``slot`` of ``y``, a dropped
    routing's the zero row) times their gates in ``y``'s dtype, then
    summed in k order in ``dtype`` (the reference's ``segment_sum`` over
    each token's k contiguous routings; no atomic scatter)."""
    d = y.shape[-1]
    yz = torch.cat([y, y.new_zeros((1, d))])
    yt = (yz[slot] * wgt[:, None].to(y.dtype)).to(dtype).reshape(-1, k, d)
    ys = yt[:, 0]
    for j in range(1, k):
        ys = ys + yt[:, j]
    return ys


def _ep_recv(t, tp: int, e_loc: int, cap: int):
    """The dispatch buffers a rank received, (tp · e_loc · cap, d) in
    source-rank order, as its experts' (e_loc, tp · cap, d) queues."""
    d = t.shape[-1]
    return t.reshape(tp, e_loc, cap, d).transpose(0, 1).reshape(
        e_loc, tp * cap, d)


def _ep_send(y, tp: int, cap: int):
    """The inverse of :func:`_ep_recv`: the experts' outputs (e_loc,
    tp · cap, d) in destination-rank order, (tp · e_loc · cap, d)."""
    e_loc, _, d = y.shape
    return y.reshape(e_loc, tp, cap, d).transpose(0, 1).reshape(
        tp * e_loc * cap, d)


def _ep_small(n_loc: int, tp: int) -> bool:
    """The reference's static rule: a data shard's ``n_loc`` tokens that
    do not split evenly into ``tp`` non-empty slices (decode) take the
    replicated-routing body, the others the all-to-all body."""
    return not (n_loc % tp == 0 and n_loc >= tp)


def _wait(t):
    from torch.distributed._functional_collectives import \
        AsyncCollectiveTensor
    return t.wait() if isinstance(t, AsyncCollectiveTensor) else t


class _AllToAll(torch.autograd.Function):
    """Equal-split all-to-all of dim 0 over ``group``; with equal splits
    it is its own adjoint, so the backward is the same exchange."""

    @staticmethod
    def forward(ctx, t, group):
        from torch.distributed import _functional_collectives as funcol
        ctx.group = group
        return _wait(funcol.all_to_all_single(t.contiguous(), None, None,
                                              group))

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.group), None


class _GatherRows(torch.autograd.Function):
    """All-gather of dim 0 over ``group`` into an output that is the same
    on every rank.  The gradient arriving there is the same on every
    rank (a replicated DTensor's), so each rank's input takes its own
    rows of it — the reference's unchecked ``shard_map`` divides the
    replicated cotangent by the axis size before its reduce-scatter, to
    the same effect."""

    @staticmethod
    def forward(ctx, t, group, rank):
        from torch.distributed import _functional_collectives as funcol
        ctx.rank, ctx.rows = rank, t.shape[0]
        return _wait(funcol.all_gather_tensor(t.contiguous(), 0, group))

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.rows
        return g[lo:lo + ctx.rows], None, None


class _SumRanks(torch.autograd.Function):
    """All-reduce (sum) over ``group`` into an output that is the same on
    every rank; the gradient of each rank's term is the (replicated)
    output gradient itself."""

    @staticmethod
    def forward(ctx, t, group):
        from torch.distributed import _functional_collectives as funcol
        return _wait(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _moe_ep(ctx: Ctx, cfg: ArchConfig, p: MoE, x):
    """Expert parallelism over the ``model`` axis: the JAX package's
    ``_moe_ep``, its ``shard_map`` a ``local_map``.

    Placements: ``x`` its batch rows over the data-parallel axes, whole
    over ``model``; the router whole; the experts' leading dim over
    ``model`` (``e_loc = E / tp`` a rank), whole elsewhere; FSDP-sharded
    experts are gathered on the way in (the reference's
    ``moe_fsdp_mode`` has no effect there: it gathers in both modes).
    Each rank's body (:func:`_ep_small` picks one, from the
    static token count of a data shard):

    - all-to-all (prefill, training): the rank's ``n_loc / tp`` token
      slice is routed under ``cap = max(8, ⌈n · k · capacity_factor /
      E⌉)``, laid out (tp, e_loc, cap, d) and exchanged so each rank
      holds its experts' queues from every rank (:class:`_AllToAll`);
      its experts run (:func:`_expert_ffn`); the outputs go back; each
      token's k outputs are summed in fp32, cast to x's dtype, and the
      slices gathered over ``model`` (:class:`_GatherRows`);
    - replicated routing (decode with fewer tokens a data shard than
      ``tp``, or a count ``tp`` does not divide): every rank routes all
      its data shard's tokens, keeps its own experts' routings under the
      same capacity rule, sums each token's k outputs in x's dtype, and
      the ranks' sums are added (:class:`_SumRanks`).

    The layout is static: no value comes back to the host.  A ``model``
    axis of 1 runs the same bodies without a collective.  The gradients
    leave the body partial over the ranks that saw other tokens (the
    router's and x's over ``model``, the router's and the weights' over
    the data axes) and DTensor reduces them."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = ctx.mesh
    names = mesh.mesh_dim_names
    tp = mesh.size(names.index("model"))
    rank = mesh.get_coordinate()[names.index("model")]
    group = mesh.get_group("model") if tp > 1 else None
    e, k = cfg.n_experts, cfg.top_k
    e_loc = e // tp
    b, s, d = x.shape
    dp = math.prod(mesh.size(i) for i, a in enumerate(names) if a in DP_AXES)
    split = b % dp == 0
    n_loc = (b // dp if split else b) * s

    def place(model, data):
        return tuple(model if a == "model" else data for a in names)

    rows = Shard(0) if split else Replicate()
    part = Partial() if split else Replicate()
    x_pl, x_grad = place(Replicate(), rows), place(Partial(), rows)
    r_pl, r_grad = place(Replicate(), Replicate()), place(Partial(), part)
    w_pl, w_grad = place(Shard(0), Replicate()), place(Shard(0), part)

    def ep_fn(xl, router_w, wg, wu, wd):
        x2 = xl.reshape(n_loc, d)
        n_slice = n_loc // tp
        xs = x2[rank * n_slice:(rank + 1) * n_slice]
        disp, slot, wgt, cap = _ep_dispatch(cfg, router_w, xs, 0, e)
        if tp > 1:
            disp = _AllToAll.apply(disp, group)
        y = _expert_ffn(ctx, _ep_recv(disp, tp, e_loc, cap), wg, wu, wd)
        y = _ep_send(y, tp, cap)
        if tp > 1:
            y = _AllToAll.apply(y, group)
        ys = _ep_combine(y, slot, wgt, k, torch.float32).to(xl.dtype)
        if tp > 1:
            ys = _GatherRows.apply(ys, group, rank)
        return ys.reshape(xl.shape)

    def ep_small_fn(xl, router_w, wg, wu, wd):
        x2 = xl.reshape(n_loc, d)
        disp, slot, wgt, cap = _ep_dispatch(cfg, router_w, x2,
                                            rank * e_loc, e_loc)
        y = _expert_ffn(ctx, disp.reshape(e_loc, cap, d), wg, wu, wd)
        ys = _ep_combine(y.reshape(e_loc * cap, d), slot, wgt, k, y.dtype)
        if tp > 1:
            ys = _SumRanks.apply(ys, group)
        return ys.reshape(xl.shape)

    body = ep_small_fn if _ep_small(n_loc, tp) else ep_fn
    return local_map(body, out_placements=list(x_pl),
                     in_placements=(x_pl, r_pl, w_pl, w_pl, w_pl),
                     in_grad_placements=(x_grad, r_grad, w_grad, w_grad,
                                         w_grad),
                     device_mesh=mesh, redistribute_inputs=True)(
        x, p.router, p.w_gate, p.w_up, p.w_down)


def moe_ffn_ep_plain(ctx: Ctx, cfg: ArchConfig, p: MoE, x, dp: int,
                     tp: int):
    """The plain version of :func:`_moe_ep` at (dp, tp): every rank's
    body in turn in one process, on plain tensors, with the collectives
    done here — the all-to-all a transpose of the per-rank lists, the
    sum over ``model`` an addition in rank order, the all-gather a
    concatenation.  ``x`` (B, S, d) and the weights whole; the routed
    part only, as :func:`_moe_ep`.  The yardstick a sharded run is held
    against (tests, ``chip_smoke.py``); no entry point calls it."""
    e, k = cfg.n_experts, cfg.top_k
    e_loc = e // tp
    b, s, d = x.shape
    shards = dp if b % dp == 0 else 1
    rows = b // shards
    n_loc = rows * s
    w = [tuple(t[j * e_loc:(j + 1) * e_loc]
               for t in (p.w_gate, p.w_up, p.w_down)) for j in range(tp)]
    out = []
    for i in range(shards):
        x2 = x[i * rows:(i + 1) * rows].reshape(n_loc, d)
        if _ep_small(n_loc, tp):
            ys = None
            for r in range(tp):
                disp, slot, wgt, cap = _ep_dispatch(cfg, p.router, x2,
                                                    r * e_loc, e_loc)
                y = _expert_ffn(ctx, disp.reshape(e_loc, cap, d), *w[r])
                part = _ep_combine(y.reshape(e_loc * cap, d), slot, wgt, k,
                                   y.dtype)
                ys = part if ys is None else ys + part
            out.append(ys)
            continue
        n_slice = n_loc // tp
        routed = [_ep_dispatch(cfg, p.router,
                               x2[r * n_slice:(r + 1) * n_slice], 0, e)
                  for r in range(tp)]
        cap = routed[0][3]
        # rank j receives chunk j of every rank's buffer, in rank order
        sent = [t[0].reshape(tp, e_loc * cap, d) for t in routed]
        back = [_ep_send(_expert_ffn(
                    ctx, _ep_recv(torch.cat([sent[r][j] for r in range(tp)]),
                                  tp, e_loc, cap), *w[j]), tp, cap)
                .reshape(tp, e_loc * cap, d) for j in range(tp)]
        out += [_ep_combine(torch.cat([back[j][r] for j in range(tp)]),
                            routed[r][1], routed[r][2], k,
                            torch.float32).to(x.dtype) for r in range(tp)]
    return torch.cat(out).reshape(b, s, d)


# (dp, tp) while :func:`plain_ep_routing` is entered, else None
_plain_ep = None


@contextlib.contextmanager
def plain_ep_routing(dp: int, tp: int):
    """Within it, :func:`moe_ffn` off a mesh routes through
    :func:`moe_ffn_ep_plain` at (dp, tp) instead of :func:`_moe_routed`:
    the model a sharded run on a (dp, tp) mesh is held against, since
    the capacity, and so the routings kept, depend on tp.  For the tests
    and ``chip_smoke.py``."""
    global _plain_ep
    prev, _plain_ep = _plain_ep, (dp, tp)
    try:
        yield
    finally:
        _plain_ep = prev


def moe_aux_loss(cfg: ArchConfig, router_w, x) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss: ``E * sum_e (share of
    top-k routings to e) * (mean router probability of e)``.  On DTensors
    each rank sums its batch rows' routings and probabilities
    (``local_map``; the sums partial over the data-parallel axes), and
    the shares and the loss are DTensor arithmetic on them."""
    n = math.prod(x.shape[:-1])
    if is_dtensor(x):
        from torch.distributed.tensor import Partial, Replicate
        from torch.distributed.tensor.experimental import local_map
        mesh = x.device_mesh
        rows = batch_placements(mesh, rows=x.shape[0])
        sums = tuple(Partial() if pl != Replicate() else pl for pl in rows)
        tokens, probs = local_map(
            functools.partial(_aux_sums, cfg),
            out_placements=(list(sums), list(sums)),
            in_placements=(rows, (Replicate(),) * mesh.ndim),
            in_grad_placements=(rows, sums), device_mesh=mesh,
            redistribute_inputs=True)(x, router_w)
    else:
        tokens, probs = _aux_sums(cfg, x, router_w)
    return cfg.n_experts * torch.sum((tokens / n) * (probs / n))


def _aux_sums(cfg: ArchConfig, x, router_w):
    """(top-k routings to each expert, summed router probabilities of
    each expert) over the tokens of ``x`` (..., d), fp32."""
    probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                          @ router_w.float(), dim=-1)
    _, eidx = _top_k(probs, cfg.top_k)
    onehot = F.one_hot(eidx, cfg.n_experts).float()
    return onehot.sum(dim=1).sum(dim=0), probs.sum(dim=0)
