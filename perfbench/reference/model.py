"""The plain reference: a decoder-only transformer (Qwen2's dense GQA
block with QKV bias; granite-moe's block with a top-k routed GLU expert
layer) in float32, written from the published descriptions with plain
``torch`` operations.  It imports nothing of the port and reads only the
configuration file's numbers and the benchmark's weights.

It computes one sequence at a time from position 0, layer by layer,
attention in blocks of queries so that an 8k-token sequence fits, and
returns the logits at the positions asked for.

Departures from the published descriptions, each shared by the port:
- RoPE rotates interleaved pairs ``(x[2i], x[2i+1])`` and not the two
  halves of a head (``rotate_half``); the two are the same model under a
  fixed permutation of each head's query and key columns.
- granite's ``attention_multiplier``, ``embedding_multiplier``,
  ``residual_multiplier`` and ``logits_scaling`` are applied with the
  values the configuration file states (the port runs 1/sqrt(head_dim)
  and 1; the file lists them under ``reduced``).

``linear`` is the one place a product is made.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def linear_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.float()


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd), interleaved pairs rotated by ``pos * freq``."""
    hd = x.shape[-1]
    freq = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device,
                                        dtype=torch.float32) / hd)
    ang = pos.float()[:, None, None] * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * cos - b * sin, b * cos + a * sin],
                       dim=-1).reshape(x.shape)


def causal_attention(q, k, v, scale: float, block: int = 1024):
    """q (S, H, hd), k/v (S, KV, hd): each query attends keys 0..itself;
    the H heads share the KV heads in groups of H / KV."""
    s, h, hd = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)     # (H, S, hd)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for a in range(0, s, block):
        z = min(s, a + block)
        qb = q[a:z].transpose(0, 1)                        # (H, b, hd)
        sc = (qb @ k[:, :z].transpose(1, 2)) * scale       # (H, b, z)
        keep = (torch.arange(z, device=q.device)[None, :]
                <= torch.arange(a, z, device=q.device)[:, None])
        sc = sc.masked_fill(~keep, float("-inf"))
        out[a:z] = (torch.softmax(sc, dim=-1) @ v[:, :z]).transpose(0, 1)
    return out


def moe(x, w: dict, pre: str, c: dict, linear: Callable):
    """Top-k routed GLU experts: router softmax in fp32, the k largest
    (ties to the lower index), gates renormalised to sum 1, each token
    through its k experts, outputs summed with the gates."""
    e, k = int(c["num_local_experts"]), int(c["num_experts_per_tok"])
    probs = torch.softmax(x @ w[pre + "moe.router"].float(), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    y = torch.zeros_like(x)
    wg, wu, wd = (w[pre + n] for n in ("moe.w_gate", "moe.w_up",
                                       "moe.w_down"))
    for j in range(e):
        tok, slot = torch.nonzero(idx == j, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        he = F.silu(linear(xe, wg[j])) * linear(xe, wu[j])
        y.index_add_(0, tok, linear(he, wd[j])
                     * gates[tok, slot][:, None])
    return y


@torch.no_grad()
def logits_at(c: dict, w: dict, tokens: torch.Tensor,
              positions: torch.Tensor,
              linear: Callable = linear_fp32) -> torch.Tensor:
    """float32 logits (len(positions), vocab) of the sequence ``tokens``
    (1-D, on the weights' device) at ``positions``."""
    d, n_l = int(c["hidden_size"]), int(c["num_hidden_layers"])
    h, kv = int(c["num_attention_heads"]), int(c["num_key_value_heads"])
    hd = int(c.get("head_dim") or d // h)
    eps = float(c["rms_norm_eps"])
    theta = float(c["rope_theta"])
    scale = float(c.get("attention_multiplier", hd ** -0.5))
    res = float(c.get("residual_multiplier", 1.0))
    bias = bool(c.get("qkv_bias", c.get("attention_bias", False)))
    s = tokens.shape[0]
    pos = torch.arange(s, device=tokens.device)
    x = w["embed"][tokens].float() * float(c.get("embedding_multiplier",
                                                 1.0))
    for i in range(n_l):
        p = f"blocks.{i}."
        hn = rmsnorm(x, w[p + "attn_norm.scale"], eps)
        q, k, v = (linear(hn, w[p + "attn." + n]) for n in ("wq", "wk",
                                                          "wv"))
        if bias:
            q = q + w[p + "attn.bq"].float()
            k = k + w[p + "attn.bk"].float()
            v = v + w[p + "attn.bv"].float()
        q = rope(q.reshape(s, h, hd), pos, theta)
        k = rope(k.reshape(s, kv, hd), pos, theta)
        o = causal_attention(q, k, v.reshape(s, kv, hd), scale)
        x = x + res * linear(o.reshape(s, h * hd), w[p + "attn.wo"])
        hn = rmsnorm(x, w[p + "mlp_norm.scale"], eps)
        if int(c.get("num_local_experts", 0)):
            y = moe(hn, w, p, c, linear)
        else:
            y = linear(F.silu(linear(hn, w[p + "mlp.w_gate"]))
                       * linear(hn, w[p + "mlp.w_up"]), w[p + "mlp.w_down"])
        x = x + res * y
    x = rmsnorm(x[positions], w["final_norm.scale"], eps)
    head = w["embed"].T if c.get("tie_word_embeddings") else w["lm_head"]
    return linear(x, head) / float(c.get("logits_scaling", 1.0))


def fp32_matmuls():
    """A context in which float32 products are float32 (TF32 off)."""
    class _Ctx:
        def __enter__(self):
            self.saved = (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32,
                          torch.get_float32_matmul_precision())
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")

        def __exit__(self, *exc):
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, prec) = self.saved
            torch.set_float32_matmul_precision(prec)
    return _Ctx()


def gap_of(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """How far each chosen token's reference logit lies below the
    reference's best at its position."""
    return ref.max(dim=-1).values - ref.gather(-1, chosen[:, None])[:, 0]

