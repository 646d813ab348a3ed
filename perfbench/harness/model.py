"""A configuration file's model: the weights the benchmark makes from the
seed, and the port's model built over them.

The weights are the benchmark's inputs.  They are drawn on the device
with a ``torch.Generator`` seeded from ``--seed``, one call per kind of
matrix for all layers together, in the dtype the configuration serves
them in, and named as the port's parameters.  The port receives these
same tensors (no copy); the plain reference reads them too, after the
window, and works out everything else itself.
"""

from __future__ import annotations

import math

import torch

# keys of a configuration file whose values the port cannot change: it
# runs them at these values, so a file that states others is refused
PORT_FIXED = {"rms_norm_eps": 1e-6, "hidden_act": "silu",
              "embedding_multiplier": 1.0, "residual_multiplier": 1.0,
              "logits_scaling": 1.0}


def head_dim(c: dict) -> int:
    return int(c.get("head_dim") or c["hidden_size"]
               // c["num_attention_heads"])


def is_moe(c: dict) -> bool:
    return int(c.get("num_local_experts", 0)) > 0


def qkv_bias(c: dict) -> bool:
    return bool(c.get("qkv_bias", c.get("attention_bias", False)))


def check_port_can_run(c: dict) -> None:
    """Raise where the file states a value the port does not compute."""
    bad = [f"{k}={c[k]!r} (the port runs {v!r})"
           for k, v in PORT_FIXED.items() if k in c and c[k] != v]
    scale = c.get("attention_multiplier")
    if scale is not None and not math.isclose(scale, head_dim(c) ** -0.5):
        bad.append(f"attention_multiplier={scale} (the port runs "
                   f"{head_dim(c) ** -0.5})")
    if bad:
        raise ValueError("the port cannot run this configuration: "
                         + "; ".join(bad))


def arch_config(c: dict):
    """The port's ``ArchConfig`` for configuration file ``c``."""
    from repro_torch.configs.base import ArchConfig
    check_port_can_run(c)
    moe = is_moe(c)
    kw = {}
    if moe:
        kw = dict(n_experts=int(c["num_local_experts"]),
                  top_k=int(c["num_experts_per_tok"]),
                  d_expert=int(c["intermediate_size"]), n_shared_experts=0)
    return ArchConfig(
        name=c["name"], family="moe" if moe else "dense",
        n_layers=int(c["num_hidden_layers"]), d_model=int(c["hidden_size"]),
        n_heads=int(c["num_attention_heads"]),
        n_kv_heads=int(c["num_key_value_heads"]),
        d_ff=int(c["intermediate_size"]), vocab_size=int(c["vocab_size"]),
        head_dim=head_dim(c), qkv_bias=qkv_bias(c),
        rope_theta=float(c["rope_theta"]),
        tie_embeddings=bool(c.get("tie_word_embeddings", False)),
        param_dtype=c["torch_dtype"], act_dtype=c["serving"]["act_dtype"],
        remat="none", **kw)


def weight_shapes(c: dict) -> dict[str, tuple[tuple, torch.dtype, float]]:
    """``{kind: (stacked shape, dtype, std)}``: every weight of the model,
    the per-layer ones stacked over layers.  Matrices are stored (in,
    out).  Norm scales are drawn around 1 and QKV biases around 0 (std
    given as negative: ``1 + std * N(0, 1)`` for scales), so that both
    take part in the comparison."""
    d, n_l = int(c["hidden_size"]), int(c["num_hidden_layers"])
    h, kv, hd = (int(c["num_attention_heads"]),
                 int(c["num_key_value_heads"]), head_dim(c))
    f, v = int(c["intermediate_size"]), int(c["vocab_size"])
    dt = getattr(torch, c["torch_dtype"])
    out = {"embed": ((v, d), dt, 0.02),
           "attn_norm.scale": ((n_l, d), dt, -0.1),
           "attn.wq": ((n_l, d, h * hd), dt, d ** -0.5),
           "attn.wk": ((n_l, d, kv * hd), dt, d ** -0.5),
           "attn.wv": ((n_l, d, kv * hd), dt, d ** -0.5),
           "attn.wo": ((n_l, h * hd, d), dt, (h * hd) ** -0.5),
           "mlp_norm.scale": ((n_l, d), dt, -0.1),
           "final_norm.scale": ((d,), dt, -0.1)}
    if qkv_bias(c):
        out.update({"attn.bq": ((n_l, h * hd), dt, 0.1),
                    "attn.bk": ((n_l, kv * hd), dt, 0.1),
                    "attn.bv": ((n_l, kv * hd), dt, 0.1)})
    if is_moe(c):
        e = int(c["num_local_experts"])
        out.update({"moe.router": ((n_l, d, e), torch.float32, d ** -0.5),
                    "moe.w_gate": ((n_l, e, d, f), dt, d ** -0.5),
                    "moe.w_up": ((n_l, e, d, f), dt, d ** -0.5),
                    "moe.w_down": ((n_l, e, f, d), dt, f ** -0.5)})
    else:
        out.update({"mlp.w_gate": ((n_l, d, f), dt, d ** -0.5),
                    "mlp.w_up": ((n_l, d, f), dt, d ** -0.5),
                    "mlp.w_down": ((n_l, f, d), dt, f ** -0.5)})
    if not c.get("tie_word_embeddings", False):
        out["lm_head"] = ((d, v), dt, d ** -0.5)
    return out


def make_weights(c: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The model's weights from ``seed``: one ``randn`` on the device a
    kind, scaled in place; per-layer kinds come back as the layers' views
    of the stack, named as the port's state dict."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    n_l = int(c["num_hidden_layers"])
    out: dict[str, torch.Tensor] = {}
    for kind, (shape, dt, std) in weight_shapes(c).items():
        w = torch.randn(shape, generator=gen, device=device, dtype=dt)
        if std < 0:
            w.mul_(-std).add_(1.0)
        else:
            w.mul_(std)
        if kind in ("embed", "lm_head", "final_norm.scale"):
            out[kind] = w
        else:
            for i in range(n_l):
                out[f"blocks.{i}.{kind}"] = w[i]
    return out


def port_model(c: dict, weights: dict[str, torch.Tensor], device,
               level: str | None = None):
    """(the port's model handle, its parameters holding ``weights``); with
    ``level`` under that precision policy (the port's default, bf16, and
    its exemptions otherwise)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.api import DEFAULT_EXEMPT, build_model
    from repro_torch.quant.policy import PrecisionPolicy
    cfg = arch_config(c)
    policy = None if level is None else PrecisionPolicy(
        default=level, exempt=DEFAULT_EXEMPT)
    model = build_model(cfg, policy=policy, device=device)
    params = T.LM(cfg, device="meta")
    params.load_state_dict(weights, strict=True, assign=True)
    return model, params
