"""Sub-quadratic sequence mixers: Mamba2 (SSD), mLSTM, sLSTM.

The JAX package's ``models/ssm.py`` with the same names.  Training and
prefill use the chunked parallel forms (O(S·L) with chunk L); decode
carries an O(1) recurrent state whatever the context length.  The JAX
package computes all three outside any Pallas kernel, with ``jnp``
einsums and ``lax.scan``; here they are plain PyTorch products and Python
loops over chunks (SSD, mLSTM) and time steps (sLSTM).

Numerics, as in the reference:

- Masks and stabiliser starts are finite (``NEG_INF = -1e30``, the mLSTM
  ``m0 = -1e9``): a row masked throughout would give ``-inf - (-inf)`` =
  NaN.  Padding follows the same rule: SSD pads with ``dt = 0`` (decay 1,
  no input), mLSTM with ``logi = NEG_INF`` and ``logf = 0``.
- :func:`_segsum` is a masked cumsum, never ``cs[t] - cs[s]`` (see its
  docstring); the SSD chunk-final decays reuse its last row.
- The reference's five- and four-operand einsums are written as staged
  fp32 products in one fixed order, so the CPU and the card take the
  same path and no ``(B, nc, L, L, H, P)`` intermediate is ever built.
- :func:`_causal_conv` accumulates in tap order in fp32 in both
  branches: a decode step's conv output equals prefill's bit for bit.

States follow the port's cache convention: a mixer called with a
``state`` writes the new state into those tensors in place
(``copy_``) and returns the same dict, where the JAX functions return
new arrays.  A prefill (``ctx.decode`` false) with a state leaves the
decode handoff there: the last ``ssm_conv - 1`` *pre-conv* inputs cast to
the conv state's dtype and the final recurrent state.
"""

from __future__ import annotations

import math
import types

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import Ctx, _gelu_tanh, linear, rmsnorm
from repro_torch.models.layers import _param, _weight

NEG_INF = -1e30
M0 = -1e9                   # the mLSTM stabiliser's start


def _scaled_rmsnorm(scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(types.SimpleNamespace(scale=scale), x)


def _conv_weight(gen, k: int, c: int, dtype, device) -> torch.Tensor:
    if gen is None:
        return torch.empty((k, c), dtype=dtype, device=device)
    w = torch.randn((k, c), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.1).to(dtype)


def _copy_state(state: dict, new: dict) -> dict:
    for name, t in new.items():
        state[name].copy_(t)
    return state


# =====================================================================
# Mamba2
# =====================================================================
def mamba2_dims(cfg: ArchConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    return d_in, nh, cfg.ssm_state, cfg.ssm_head_dim


class Mamba2(nn.Module):
    """Mamba2 mixer parameters, named as the JAX package's
    ``init_mamba2``: ``in_proj`` (d → z, x, B, C, dt), the depthwise conv
    ``conv_w``/``conv_b``, ``A_log``, ``D`` and ``dt_bias`` (fp32 whatever
    the parameter dtype), ``norm_scale`` and ``out_proj``.  With a
    generator the random weights are drawn in init order; without one
    they are left uninitialised for ``load_state_dict``."""

    AXES = {"in_proj": ("embed", "ssm_inner"),
            "conv_w": ("conv_k", "ssm_inner"), "conv_b": ("ssm_inner",),
            "A_log": ("ssm_heads",), "D": ("ssm_heads",),
            "dt_bias": ("ssm_heads",), "norm_scale": ("ssm_inner",),
            "out_proj": ("ssm_inner", "embed")}

    def __init__(self, cfg: ArchConfig, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        d = cfg.d_model
        d_in, nh, n, _ = mamba2_dims(cfg)
        conv_dim = d_in + 2 * n
        dt = cfg.pdt
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = _param(_weight(gen, d, 2 * d_in + 2 * n + nh, dt,
                                      device))
        self.conv_w = _param(_conv_weight(gen, cfg.ssm_conv, conv_dim, dt,
                                          device))
        self.conv_b = _param(torch.zeros((conv_dim,), dtype=dt,
                                         device=device))
        self.A_log = _param(torch.log(torch.arange(1, nh + 1, **f32)))
        self.D = _param(torch.ones((nh,), **f32))
        self.dt_bias = _param(torch.zeros((nh,), **f32))
        self.norm_scale = _param(torch.ones((d_in,), dtype=dt,
                                            device=device))
        self.out_proj = _param(_weight(gen, d_in, d, dt, device,
                                       scale=1.0 / math.sqrt(d_in)))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv over time, SiLU after.  xbc: (B,S,C); w:
    (K,C).  Returns (y in xbc's dtype, None).

    With ``state`` (B,K-1,C): a one-token decode step; returns (y (B,1,C),
    the new window ``window[:, 1:]``, in the promoted dtype of state and
    input as ``jnp.concatenate`` gives it).  Both branches sum the taps
    in tap order in fp32, so decode equals prefill bit for bit."""
    k = w.shape[0]
    wf = w.float()
    if state is not None:
        dt = torch.promote_types(state.dtype, xbc.dtype)
        window = torch.cat([state.to(dt), xbc.to(dt)], dim=1)    # (B,K,C)
        y = window[:, 0].float() * wf[0]
        for i in range(1, k):
            y = y + window[:, i].float() * wf[i]
        y = y + b.float()
        return F.silu(y)[:, None, :].to(xbc.dtype), window[:, 1:]
    s = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    y = pad[:, 0:s].float() * wf[0]
    for i in range(1, k):
        y = y + pad[:, i:i + s].float() * wf[i]
    y = y + b.float()
    return F.silu(y).to(xbc.dtype), None


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """segsum(a)[..., t, s] = sum_{j=s+1..t} a[..., j]; NEG_INF for s>t.

    A masked cumsum over the t axis, not the difference of two inclusive
    cumsums: the decay exponents share a sign and grow to O(chunk·|a|),
    so ``cs[t] - cs[s]`` loses ``eps·|cs|`` to cancellation — worst in a
    heavily padded final chunk.  Each entry here is a fresh short sum."""
    l = a.shape[-1]
    x = a[..., :, None].expand(*a.shape, l)
    strict = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                   device=a.device), diagonal=-1)
    seg = torch.cumsum(torch.where(strict, x, 0.0), dim=-2)
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=a.device))
    return torch.where(mask, seg, NEG_INF)


def mamba2_apply(ctx: Ctx, cfg: ArchConfig, p: Mamba2, x: torch.Tensor,
                 state: dict | None = None):
    """Mamba2 mixer.  Returns (y, state).

    Train/prefill: chunked SSD (:func:`_ssd_chunked`); with a ``state``
    the decode handoff is written into it.  Decode (``ctx.decode`` and a
    state): the recurrent single step over x (B,1,d), the state updated
    in place."""
    b, s, _ = x.shape
    d_in, nh, n, hd = mamba2_dims(cfg)
    proj = linear(ctx, "ssm/in_proj", x, p.in_proj)
    z, xr, b_in, c_in, dt_raw = torch.split(
        proj, [d_in, d_in, n, n, nh], dim=-1)
    xbc = torch.cat([xr, b_in, c_in], dim=-1)
    a = -torch.exp(p.A_log.float())                          # (H,) < 0
    dt = F.softplus(dt_raw.float() + p.dt_bias.float())     # (B,S,H)

    if state is not None and ctx.decode:
        xbc_c, conv_state = _causal_conv(xbc, p.conv_w, p.conv_b,
                                         state["conv"])
        xc, bc, cc = torch.split(xbc_c[:, 0], [d_in, n, n], dim=-1)
        xh = xc.reshape(b, nh, hd).float()
        dt1 = dt[:, 0]                                       # (B,H)
        da = torch.exp(dt1 * a[None, :])
        h_new = state["ssd"] * da[..., None, None] + (
            dt1[..., None, None] * xh[..., None]
            * bc.float()[:, None, None, :])                  # (B,H,P,N)
        y = torch.matmul(h_new, cc.float()[:, None, :, None])[..., 0]
        y = y + p.D.float()[None, :, None] * xh
        y = y.reshape(b, 1, d_in).to(x.dtype)
        state = _copy_state(state, {"conv": conv_state, "ssd": h_new})
    else:
        xbc_c, _ = _causal_conv(xbc, p.conv_w, p.conv_b)
        xc, bc, cc = torch.split(xbc_c, [d_in, n, n], dim=-1)
        y, h_last = _ssd_chunked(cfg, xc, bc, cc, dt, a, p.D)
        if state is not None:   # prefill: leave the final state for decode
            state = _copy_state(state, {
                "conv": xbc[:, -(cfg.ssm_conv - 1):], "ssd": h_last})
    yz = y.float() * F.silu(z.float())
    yz = _scaled_rmsnorm(p.norm_scale, yz.to(x.dtype))
    return linear(ctx, "ssm/out_proj", yz, p.out_proj), state


def _ssd_chunked(cfg: ArchConfig, xc, bc, cc, dt, a, d_skip):
    """Chunked SSD.  xc: (B,S,d_in); bc/cc: (B,S,N); dt: (B,S,H); a: (H,).
    Returns (y (B,S,d_in) fp32, the final state (B,H,P,N))."""
    b, s, d_in = xc.shape
    _, nh, n, hd = mamba2_dims(cfg)
    l = min(cfg.ssm_chunk, s)
    s_orig = s
    if s % l:   # pad with dt = 0 steps: decay 1, no state contribution
        pad = l - s % l
        xc, bc, cc, dt = (F.pad(t, (0, 0, 0, pad)) for t in (xc, bc, cc, dt))
        s = s + pad
    nc = s // l
    xh = xc.reshape(b, nc, l, nh, hd).float()
    bm = bc.reshape(b, nc, l, n).float()
    cm = cc.reshape(b, nc, l, n).float()
    dtc = dt.reshape(b, nc, l, nh)
    # per-step log decay (B,H,nc,L)
    da = (dtc * a[None, None, None, :]).permute(0, 3, 1, 2)
    da_cs = torch.cumsum(da, dim=-1)
    seg = _segsum(da)                                      # (B,H,nc,L,L)
    # intra-chunk (diagonal blocks): y[l] = sum_s (C_l·B_s) L[l,s] dt_s x_s
    cb = torch.matmul(cm, bm.transpose(-1, -2))            # (B,nc,L,L)
    wmat = (cb[:, :, None] * torch.exp(seg).permute(0, 2, 1, 3, 4)
            * dtc.permute(0, 1, 3, 2)[:, :, :, None, :])   # (B,nc,H,L,L)
    y_diag = torch.matmul(wmat, xh.permute(0, 1, 3, 2, 4))  # (B,nc,H,L,P)
    del cb, wmat
    # chunk-final states: the decay from step l to the chunk's end is
    # segsum's last row (no ``da_cs[-1] - da_cs`` cancellation)
    decay_states = torch.exp(seg[..., -1, :])              # (B,H,nc,L)
    del seg
    coef = decay_states.permute(0, 2, 3, 1) * dtc          # (B,nc,L,H)
    xw = xh * coef[..., None]                              # (B,nc,L,H,P)
    states = torch.matmul(xw.permute(0, 1, 3, 4, 2),
                          bm[:, :, None])                  # (B,nc,H,P,N)
    # inter-chunk recurrence, chunk by chunk
    chunk_decay = torch.exp(da_cs[..., -1])                # (B,H,nc)
    h = torch.zeros((b, nh, hd, n), dtype=torch.float32, device=xc.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[..., c, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                   # (B,nc,H,P,N)
    state_decay = torch.exp(da_cs).permute(0, 2, 1, 3)     # (B,nc,H,L)
    y_off = (torch.matmul(cm[:, :, None], h_prev.transpose(-1, -2))
             * state_decay[..., None])                     # (B,nc,H,L,P)
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4)            # (B,nc,L,H,P)
    y = y + d_skip.float()[None, None, None, :, None] * xh
    return y.reshape(b, s, d_in)[:, :s_orig], h


# the logical axes of each recurrent state (the JAX package's)
MAMBA2_STATE_AXES = {"conv": ("batch", None, "ssm_inner"),
                     "ssd": ("batch", "ssm_heads", None, None)}


def init_mamba2_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                      device=None) -> dict:
    """One layer's decode state: ``conv`` (B, K-1, conv_dim) in ``dtype``
    and ``ssd`` (B, H, P, N) fp32, zeros."""
    d_in, nh, n, hd = mamba2_dims(cfg)
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in + 2 * n),
                                dtype=dtype, device=device),
            "ssd": torch.zeros((batch, nh, hd, n), dtype=torch.float32,
                               device=device)}


# =====================================================================
# mLSTM (xLSTM matrix-memory cell)
# =====================================================================
class MLSTM(nn.Module):
    """mLSTM block parameters, named as the JAX package's ``init_mlstm``:
    the 2x up-projection ``w_up`` and its gate ``w_gate``, the conv,
    ``wq``/``wk``/``wv``, the input and forget gate projection ``w_if``
    with its bias ``b_if`` (0 for the input gates, 3 for the forget
    gates), ``norm_scale`` and ``w_down``."""

    AXES = {"w_up": ("embed", "ssm_inner"), "w_gate": ("embed", "ssm_inner"),
            "conv_w": ("conv_k", "ssm_inner"), "conv_b": ("ssm_inner",),
            "wq": ("ssm_inner", "heads"), "wk": ("ssm_inner", "heads"),
            "wv": ("ssm_inner", "heads"), "w_if": ("ssm_inner", None),
            "b_if": (None,), "norm_scale": ("ssm_inner",),
            "w_down": ("ssm_inner", "embed")}

    def __init__(self, cfg: ArchConfig, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        d_in = 2 * d
        dt = cfg.pdt
        self.w_up = _param(_weight(gen, d, d_in, dt, device))
        self.w_gate = _param(_weight(gen, d, d_in, dt, device))
        self.conv_w = _param(_conv_weight(gen, cfg.ssm_conv, d_in, dt,
                                          device))
        self.conv_b = _param(torch.zeros((d_in,), dtype=dt, device=device))
        for name in ("wq", "wk", "wv"):
            setattr(self, name, _param(_weight(gen, d_in, d_in, dt, device)))
        self.w_if = _param(_weight(gen, d_in, 2 * h, dt, device))
        self.b_if = _param(torch.cat([
            torch.zeros((h,), device=device),
            torch.full((h,), 3.0, device=device)]).to(dt))
        self.norm_scale = _param(torch.ones((d_in,), dtype=dt,
                                            device=device))
        self.w_down = _param(_weight(gen, d_in, d, dt, device,
                                     scale=1.0 / math.sqrt(d_in)))


def _weak_scalar(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as JAX converts a Python scalar that
    meets an array of that dtype."""
    return torch.tensor(v, dtype=dtype).item()


def mlstm_apply(ctx: Ctx, cfg: ArchConfig, p: MLSTM, x: torch.Tensor,
                state: dict | None = None):
    """mLSTM block.  Returns (y, state); the state is updated in place."""
    b, s, d = x.shape
    h = cfg.n_heads
    d_in = 2 * d
    dh = d_in // h
    up = linear(ctx, "mlstm/w_up", x, p.w_up)
    gate = linear(ctx, "mlstm/w_gate", x, p.w_gate)
    decode = state is not None and ctx.decode
    upc, conv_state = _causal_conv(up, p.conv_w, p.conv_b,
                                   state["conv"] if decode else None)

    q = linear(ctx, "mlstm/wq", upc, p.wq).reshape(b, s, h, dh)
    k = linear(ctx, "mlstm/wk", upc, p.wk).reshape(b, s, h, dh)
    k = k / _weak_scalar(math.sqrt(dh), k.dtype)
    v = linear(ctx, "mlstm/wv", up, p.wv).reshape(b, s, h, dh)
    if_raw = linear(ctx, "mlstm/w_if", upc, p.w_if, p.b_if).float()
    logi, logf = if_raw[..., :h], F.logsigmoid(if_raw[..., h:])
    qf, kf, vf = q.float(), k.float(), v.float()

    if decode:
        # recurrent step: C (B,H,dk,dv), n (B,H,dk), m (B,H)
        li, lf = logi[:, 0], logf[:, 0]
        m_new = torch.maximum(lf + state["m"], li)
        fp = torch.exp(lf + state["m"] - m_new)
        ip = torch.exp(li - m_new)
        kv = kf[:, 0, :, :, None] * vf[:, 0, :, None, :]
        c_new = state["C"] * fp[..., None, None] + ip[..., None, None] * kv
        n_new = state["n"] * fp[..., None] + ip[..., None] * kf[:, 0]
        q0 = qf[:, 0, :, None, :]                              # (B,H,1,dk)
        num = torch.matmul(q0, c_new)[..., 0, :]
        den = torch.abs(torch.matmul(q0, n_new[..., None])[..., 0, 0])
        den = torch.maximum(den, torch.exp(-m_new))
        y = (num / den[..., None])[:, None]                    # (B,1,H,dv)
        state = _copy_state(state, {"conv": conv_state, "C": c_new,
                                    "n": n_new, "m": m_new})
    else:
        y, (c_f, n_f, m_f) = _mlstm_chunked(cfg, qf, kf, vf, logi, logf)
        if state is not None:   # prefill → decode handoff
            state = _copy_state(state, {
                "conv": up[:, -(cfg.ssm_conv - 1):], "C": c_f, "n": n_f,
                "m": m_f})
    y = y.reshape(b, s, d_in)
    y = _scaled_rmsnorm(p.norm_scale, y.to(x.dtype))
    y = y.float() * F.silu(gate.float())
    return linear(ctx, "mlstm/w_down", y.to(x.dtype), p.w_down), state


def _mlstm_chunked(cfg: ArchConfig, q, k, v, logi, logf):
    """Stabilised chunkwise mLSTM.  q/k/v: (B,S,H,dh); logi/logf:
    (B,S,H).  Returns (y (B,S,H,dh), (C, n, m) after the last step)."""
    b, s, h, dh = q.shape
    l = min(cfg.mlstm_chunk, s)
    s_orig = s
    if s % l:   # pad: logf = 0 (decay 1), logi = NEG_INF (no input)
        pad = l - s % l
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        logi = F.pad(logi, (0, 0, 0, pad), value=NEG_INF)
        logf = F.pad(logf, (0, 0, 0, pad))
        s = s + pad
    nc = s // l

    def chunks(t):      # (B,S,H,...) -> (nc,B,H,L,...)
        t = t.reshape(b, nc, l, h, *t.shape[3:])
        return t.permute(1, 0, 3, 2, *range(4, t.dim()))

    qc, kc, vc, lic, lfc = (chunks(t) for t in (q, k, v, logi, logf))
    tril = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))
    C = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=q.device)
    n = torch.zeros((b, h, dh), dtype=torch.float32, device=q.device)
    m = torch.full((b, h), M0, dtype=torch.float32, device=q.device)
    ys = []
    for j in range(nc):
        qj, kj, vj, li, lf = qc[j], kc[j], vc[j], lic[j], lfc[j]
        bcs = torch.cumsum(lf, dim=-1)                         # (B,H,L)
        # D[t,s] = b_t - b_s + logi_s  (s <= t)
        dmat = bcs[..., :, None] - bcs[..., None, :] + li[..., None, :]
        dmat = torch.where(tril, dmat, NEG_INF)
        m_intra = dmat.amax(dim=-1)                            # (B,H,L)
        m_inter = m[..., None] + bcs
        m_row = torch.maximum(m_intra, m_inter)
        sc = torch.matmul(qj, kj.transpose(-1, -2)) \
            * torch.exp(dmat - m_row[..., None])               # (B,H,L,L)
        inter_w = torch.exp(m_inter - m_row)                   # (B,H,L)
        num = torch.matmul(sc, vj) \
            + inter_w[..., None] * torch.matmul(qj, C)
        den = sc.sum(dim=-1) \
            + inter_w * torch.matmul(qj, n[..., None])[..., 0]
        den = torch.maximum(torch.abs(den), torch.exp(-m_row))
        ys.append(num / den[..., None])                        # (B,H,L,dv)
        # carry update
        g = bcs[..., -1]                                       # (B,H)
        w_t = li + g[..., None] - bcs                          # (B,H,L)
        m_new = torch.maximum(m + g, w_t.amax(dim=-1))
        scale_old = torch.exp(m + g - m_new)
        wexp = torch.exp(w_t - m_new[..., None])
        C = C * scale_old[..., None, None] + torch.matmul(
            (kj * wexp[..., None]).transpose(-1, -2), vj)
        n = n * scale_old[..., None] \
            + torch.matmul(wexp[..., None, :], kj)[..., 0, :]
        m = m_new
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, s, h, dh)
    return y[:, :s_orig], (C, n, m)


MLSTM_STATE_AXES = {"conv": ("batch", None, "ssm_inner"),
                    "C": ("batch", "heads", None, None),
                    "n": ("batch", "heads", None), "m": ("batch", "heads")}


def init_mlstm_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    """One layer's decode state: ``conv`` (B, K-1, 2d) in ``dtype``, ``C``
    (B, H, dh, dh), ``n`` (B, H, dh) zeros and ``m`` (B, H) at -1e9."""
    h = cfg.n_heads
    d_in = 2 * cfg.d_model
    dh = d_in // h
    f32 = dict(dtype=torch.float32, device=device)
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in),
                                dtype=dtype, device=device),
            "C": torch.zeros((batch, h, dh, dh), **f32),
            "n": torch.zeros((batch, h, dh), **f32),
            "m": torch.full((batch, h), M0, **f32)}


def mlstm_recurrent_reference(cfg: ArchConfig, q, k, v, logi, logf):
    """Per-step recurrence — test oracle for the chunked form."""
    b, s, h, dh = q.shape
    C = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=q.device)
    n = torch.zeros((b, h, dh), dtype=torch.float32, device=q.device)
    m = torch.full((b, h), M0, dtype=torch.float32, device=q.device)
    ys = []
    for t in range(s):
        qt, kt, vt, li, lf = q[:, t], k[:, t], v[:, t], logi[:, t], logf[:, t]
        m_new = torch.maximum(lf + m, li)
        fp = torch.exp(lf + m - m_new)
        ip = torch.exp(li - m_new)
        C = C * fp[..., None, None] + ip[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = n * fp[..., None] + ip[..., None] * kt
        m = m_new
        num = torch.matmul(qt[..., None, :], C)[..., 0, :]
        den = torch.maximum(
            torch.abs(torch.matmul(qt[..., None, :], n[..., None])[..., 0, 0]),
            torch.exp(-m))
        ys.append(num / den[..., None])
    return torch.stack(ys, dim=1)


# =====================================================================
# sLSTM (scalar-memory cell with recurrent block-diagonal weights)
# =====================================================================
class SLSTM(nn.Module):
    """sLSTM block parameters, named as the JAX package's ``init_slstm``:
    ``w_in`` (d → z, i, f, o) with its bias ``b`` (3 for the forget
    gates), the block-diagonal recurrent weights ``r`` (4, H, dh, dh),
    ``gn_scale``, ``w_out`` and the post-cell gated FFN ``w_ff_up`` /
    ``w_ff_down`` (pf = 4/3)."""

    AXES = {"w_in": ("embed", None), "r": (None, "heads", None, None),
            "b": (None,), "gn_scale": ("embed",), "w_out": ("embed", "embed"),
            "w_ff_up": ("embed", "ffn"), "w_ff_down": ("ffn", "embed")}

    def __init__(self, cfg: ArchConfig, device=None,
                 gen: torch.Generator | None = None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        dh = d // h
        dt = cfg.pdt
        self.w_in = _param(_weight(gen, d, 4 * d, dt, device))
        if gen is None:
            r = torch.empty((4, h, dh, dh), dtype=dt, device=device)
        else:
            r = (torch.randn((4, h, dh, dh), generator=gen,
                             device=gen.device) / math.sqrt(dh)).to(dt)
        self.r = _param(r)
        self.b = _param(torch.cat([
            torch.zeros((2 * d,), device=device),
            torch.full((d,), 3.0, device=device),
            torch.zeros((d,), device=device)]).to(dt))
        self.gn_scale = _param(torch.ones((d,), dtype=dt, device=device))
        self.w_out = _param(_weight(gen, d, d, dt, device))
        self.w_ff_up = _param(_weight(gen, d, (4 * d) // 3 * 2, dt, device))
        self.w_ff_down = _param(_weight(gen, (4 * d) // 3, d, dt, device))


def slstm_apply(ctx: Ctx, cfg: ArchConfig, p: SLSTM, x: torch.Tensor,
                state: dict | None = None):
    """sLSTM block: a sequential loop over time.  Returns (y, state).

    Decoding (``ctx.decode`` and a state) continues from the state;
    otherwise the carry starts at h = c = 0, n = 1, m = 0 even when a
    state is given, and the state receives the final carry."""
    b, s, d = x.shape
    h = cfg.n_heads
    dh = d // h
    wx = linear(ctx, "slstm/w_in", x, p.w_in, p.b).float()
    wx = wx.reshape(b, s, 4, h, dh)
    r = p.r.float()

    if state is not None and ctx.decode:
        hp, cp, np_, mp = (state[k] for k in ("h", "c", "n", "m"))
    else:
        hp = cp = torch.zeros((b, h, dh), dtype=torch.float32,
                              device=x.device)
        np_ = torch.ones_like(hp)
        mp = torch.zeros_like(hp)
    ys = []
    for t in range(s):
        wx_t = wx[:, t]                                       # (B,4,H,dh)
        # rec[g,b,h,j] = sum_i r[g,h,i,j] h[b,h,i]
        rec = torch.matmul(hp[None, :, :, None, :], r[:, None])[..., 0, :]
        zt = torch.tanh(wx_t[:, 0] + rec[0])
        it = wx_t[:, 1] + rec[1]
        ft = wx_t[:, 2] + rec[2]
        ot = torch.sigmoid(wx_t[:, 3] + rec[3])
        logf = F.logsigmoid(ft)
        m_new = torch.maximum(logf + mp, it)
        ip = torch.exp(it - m_new)
        fp = torch.exp(logf + mp - m_new)
        cp = fp * cp + ip * zt
        np_ = fp * np_ + ip
        hp = ot * cp / torch.clamp(np_, min=1e-6)
        mp = m_new
        ys.append(hp)
    if state is not None:
        state = _copy_state(state, {"h": hp, "c": cp, "n": np_, "m": mp})
    yh = torch.stack(ys, dim=1)                               # (B,S,H,dh)
    # per-head group norm (population variance)
    mu = yh.mean(dim=-1, keepdim=True)
    var = yh.var(dim=-1, keepdim=True, unbiased=False)
    y = ((yh - mu) * torch.rsqrt(var + 1e-6)).reshape(b, s, d)
    y = (y * p.gn_scale.float()).to(x.dtype)
    y = linear(ctx, "slstm/w_out", y, p.w_out)
    # gated FFN
    ff = linear(ctx, "slstm/w_ff_up", y, p.w_ff_up)
    f1, f2 = ff.chunk(2, dim=-1)
    ffh = (_gelu_tanh(f1.float()) * f2.float()).to(x.dtype)
    return y + linear(ctx, "slstm/w_ff_down", ffh, p.w_ff_down), state


SLSTM_STATE_AXES = {k: ("batch", "heads", None) for k in ("h", "c", "n", "m")}


def init_slstm_state(cfg: ArchConfig, batch: int, device=None) -> dict:
    """One layer's decode state: ``h``, ``c``, ``m`` zeros and ``n`` ones,
    (B, H, dh) fp32 each."""
    h = cfg.n_heads
    shape = (batch, h, cfg.d_model // h)
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros(shape, **f32), "c": torch.zeros(shape, **f32),
            "n": torch.ones(shape, **f32), "m": torch.zeros(shape, **f32)}
