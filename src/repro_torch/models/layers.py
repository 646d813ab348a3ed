"""Dense GQA attention and MLPs.

Attention has the JAX package's execution paths for dense GQA layers:

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
:func:`mea_attention`) for a CPU tensor.  MLA and MoE are not ported yet.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (Ctx, Norm, act_fn, apply_rope,
                                       dense_init, linear, norm_apply)

NEG_INF = -1e30
EMPTY_POS = 2**30


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# =====================================================================
# Attention
# =====================================================================
class Attention(nn.Module):
    """Attention parameters: ``wq/wk/wv/wo`` stored ``(in, out)``, the
    optional QKV biases and q/k norms.  With a generator the weights are
    drawn as the JAX package's ``init_attention`` draws them (biases 0,
    norms 1); without one they are left uninitialised for
    ``load_state_dict``."""

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
            w = (dense_init(gen, d_in, d_out, dt, scale) if gen is not None
                 else torch.empty((d_in, d_out), dtype=dt, device=device))
            setattr(self, name, _param(w))
        if cfg.qkv_bias:
            self.bq = _param(torch.zeros((h * hd,), dtype=dt, device=device))
            self.bk = _param(torch.zeros((kv * hd,), dtype=dt,
                                         device=device))
            self.bv = _param(torch.zeros((kv * hd,), dtype=dt,
                                         device=device))
        if cfg.qk_norm:
            self.q_norm = Norm(cfg.norm, hd, dt, device)
            self.k_norm = Norm(cfg.norm, hd, dt, device)


def _qkv(ctx: Ctx, cfg: ArchConfig, p: Attention, x: torch.Tensor):
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    b, s, _ = x.shape
    q = linear(ctx, "attn/wq", x, p.wq, getattr(p, "bq", None))
    k = linear(ctx, "attn/wk", x, p.wk, getattr(p, "bk", None))
    v = linear(ctx, "attn/wv", x, p.wv, getattr(p, "bv", None))
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = norm_apply(cfg.norm, p.q_norm, q)
        k = norm_apply(cfg.norm, p.k_norm, k)
    return q, k, v


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
              cache: dict | None = None, causal: bool = True):
    """Full attention layer.  Returns (y, cache).

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
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.hd
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


def cache_len_for(cfg: ArchConfig, seq_len: int) -> int:
    """Slots of a contiguous cache for ``seq_len`` tokens: all of them, or
    the window under a sliding window (the ring buffer)."""
    return seq_len if not cfg.sliding_window else min(seq_len,
                                                      cfg.sliding_window)


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


def _contiguous_attention_decode(cfg: ArchConfig, q, k, v, cache):
    """Cached attention of ``s`` new tokens at ``cache["pos"]``.

    q/k/v: (B, s, ·, hd), already roped at ``pos + i``.  The new K/V is
    written in place at slot ``pos`` (``pos % cache_len`` in the ring),
    with the start clamped so the ``s`` rows fit, as the JAX package's
    ``dynamic_update_slice`` clamps; then every query attends the cache
    under the batch-shared mask from :func:`kv_positions_for_cache` /
    :func:`decode_attention_mask` at ``pos`` — through flash_decode for
    one token, through the plain masked attention for ``s > 1`` (the
    kernel is single-token, as the JAX package's is).  The write precedes
    the kernel's read on the same stream.  Returns (out, cache with
    ``pos + s``)."""
    from repro_torch.kernels.flash_decode import flash_decode
    ck, cv = cache["k"], cache["v"]
    pos = int(cache["pos"])
    s = q.shape[1]
    cache_len = ck.shape[1]
    idx = pos % cache_len if cfg.sliding_window else pos
    start = min(max(idx, 0), cache_len - s)
    ck[:, start:start + s] = k.to(ck.dtype)
    cv[:, start:start + s] = v.to(cv.dtype)
    kv_pos = kv_positions_for_cache(pos, cache_len, cfg.sliding_window,
                                    device=ck.device)
    mask = decode_attention_mask(kv_pos, pos, cfg.sliding_window)
    if s == 1:
        out = flash_decode(q.contiguous(), ck, cv, mask)
    else:
        out = _masked_decode_attention(q, ck, cv, mask, cfg.n_heads)
    return out, {"k": ck, "v": cv, "pos": pos + s}


def _fill_contiguous_cache(cfg: ArchConfig, k, v, cache):
    """Prefill of ``s`` tokens from position 0: the last ``cache_len`` of
    them go into the cache in place, rotated under a sliding window so
    position ``p`` sits at slot ``p % cache_len`` (the layout decode's
    :func:`kv_positions_for_cache` recovers).  Returns the cache with
    ``pos = s``."""
    ck, cv = cache["k"], cache["v"]
    s = k.shape[1]
    cache_len = ck.shape[1]
    kk, vv = (k, v) if s <= cache_len else (k[:, -cache_len:],
                                            v[:, -cache_len:])
    if cfg.sliding_window and s > cache_len:
        shift = s % cache_len
        kk = torch.roll(kk, shift, dims=1)
        vv = torch.roll(vv, shift, dims=1)
    ck[:, :kk.shape[1]] = kk.to(ck.dtype)
    cv[:, :vv.shape[1]] = vv.to(cv.dtype)
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
    flash_prefill_ragged (its default ``block_q``).
    """
    if cfg.sliding_window:
        raise ValueError("paged prefill supports linear caches only")
    from repro_torch.kernels.flash_prefill_ragged import flash_prefill_ragged
    kp, vp = cache["k_pages"], cache["v_pages"]
    bt, off = cache["block_tables"], cache["seq_lens"]
    lens = cache["prefill_lens"]
    ps = kp.shape[1]
    r, s = q.shape[:2]
    n_slots = bt.shape[1] * ps
    pos = ragged_prefill_positions(off, s)
    valid = torch.arange(s, device=q.device)[None] < lens[:, None]
    pos_c = torch.clamp(pos, max=n_slots - 1).long()
    rows = torch.arange(r, device=q.device)[:, None]
    pidx = torch.where(valid, bt[rows, pos_c // ps], 0).long()
    slot = pos_c % ps
    kp[pidx, slot] = k.to(kp.dtype)
    vp[pidx, slot] = v.to(vp.dtype)
    return flash_prefill_ragged(q, kp, vp, bt, off, lens)


# =====================================================================
# Dense MLPs
# =====================================================================
class MLP(nn.Module):
    """GLU (``w_gate``, ``w_up``, ``w_down``) or GELU MLP (``w_up``,
    ``w_down`` and optional biases) parameters, stored ``(in, out)``;
    drawn from ``gen`` as the JAX package's ``init_mlp`` draws them, or
    left uninitialised without one."""

    def __init__(self, cfg: ArchConfig, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        dt = cfg.pdt
        names = ["w_gate", "w_up", "w_down"] if cfg.mlp == "glu" \
            else ["w_up", "w_down"]
        for name in names:
            d_in, d_out = (f, d) if name == "w_down" else (d, f)
            scale = 1.0 / math.sqrt(f) if name == "w_down" else None
            w = (dense_init(gen, d_in, d_out, dt, scale) if gen is not None
                 else torch.empty((d_in, d_out), dtype=dt, device=device))
            setattr(self, name, _param(w))
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
