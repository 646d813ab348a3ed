"""What the served work needs, counted from the configuration file's
sizes and the requests' lengths, whatever implements it.

- FLOPs of the model: 2 per multiply-add of every projection a token
  goes through (the active experts only, the router included), the
  attention pairs that causality needs (4 · heads · head_dim a query-key
  pair: QKᵀ and PV), and the ``lm_head`` once a sequence at its last
  prompt position and once a decoded token.
- The two paged attention kernels: operations as above, bytes with each
  input read once and each output written once (q, the K/V of every
  key position attended, the output), in the cache's 2-byte dtype.
- The least time of a launch: the larger of bytes over the memory
  bandwidth and operations over the peak, from :data:`PEAK`.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak and HBM3
# bandwidth, at the full 700 W power limit
PEAK = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}
CACHE_BYTES = 2          # bf16 K/V pages, queries and outputs


def dims(c: dict) -> dict:
    d, h, kv = (int(c["hidden_size"]), int(c["num_attention_heads"]),
                int(c["num_key_value_heads"]))
    hd = int(c.get("head_dim") or d // h)
    return {"d": d, "h": h, "kv": kv, "hd": hd,
            "layers": int(c["num_hidden_layers"]),
            "f": int(c["intermediate_size"]), "v": int(c["vocab_size"]),
            "e": int(c.get("num_local_experts", 0)),
            "k": int(c.get("num_experts_per_tok", 0))}


def linear_flops_per_token(c: dict) -> float:
    """Projections of one token through every layer (no ``lm_head``)."""
    m = dims(c)
    d, hd = m["d"], m["hd"]
    attn = d * (m["h"] * hd + 2 * m["kv"] * hd) + m["h"] * hd * d
    if m["e"]:
        ffn = d * m["e"] + m["k"] * 3 * d * m["f"]
    else:
        ffn = 3 * d * m["f"]
    return 2.0 * m["layers"] * (attn + ffn)


def causal_pairs(shared: int, suffix: int) -> int:
    """Query-key pairs of ``suffix`` queries after ``shared`` cached
    tokens, each attending every earlier position and itself."""
    return suffix * shared + suffix * (suffix + 1) // 2


def decode_pairs(keys0: int, steps: int) -> int:
    """Pairs of ``steps`` decode steps whose first attends ``keys0``
    keys."""
    return steps * keys0 + steps * (steps - 1) // 2


def attn_flops_per_pair(c: dict) -> float:
    m = dims(c)
    return 4.0 * m["h"] * m["hd"] * m["layers"]


def head_flops(c: dict) -> float:
    m = dims(c)
    return 2.0 * m["d"] * m["v"]


def prefill_flops(c: dict, shared: int, suffix: int) -> float:
    return (suffix * linear_flops_per_token(c)
            + causal_pairs(shared, suffix) * attn_flops_per_pair(c)
            + head_flops(c))


def decode_flops(c: dict, keys0: int, steps: int) -> float:
    return steps * (linear_flops_per_token(c) + head_flops(c)) \
        + decode_pairs(keys0, steps) * attn_flops_per_pair(c)


def least_s(flops: float, nbytes: float) -> float:
    return max(nbytes / PEAK["hbm_bytes_per_s"], flops / PEAK["bf16_flops"])


def prefill_kernel_least_s(c: dict, rows) -> float:
    """Least time of one layer's ragged prefill launch over ``rows``
    [(shared, suffix), ...], times the layers."""
    m = dims(c)
    q_bytes = m["h"] * m["hd"] * CACHE_BYTES
    kv_bytes = 2 * m["kv"] * m["hd"] * CACHE_BYTES
    flops = sum(causal_pairs(s, n) for s, n in rows) * 4.0 * m["h"] * m["hd"]
    nbytes = sum(2 * n * q_bytes + (s + n) * kv_bytes for s, n in rows)
    return m["layers"] * least_s(flops, nbytes)


def decode_kernel_least_s(c: dict, rows) -> float:
    """Least time of the paged decode launches of one segment whose rows
    are [(keys at the first step, steps), ...]: each step one launch a
    layer over the rows still decoding."""
    m = dims(c)
    q_bytes = m["h"] * m["hd"] * CACHE_BYTES
    kv_bytes = 2 * m["kv"] * m["hd"] * CACHE_BYTES
    total = 0.0
    for t in range(max((n for _, n in rows), default=0)):
        keys = [k0 + t for k0, n in rows if n > t]
        flops = sum(keys) * 4.0 * m["h"] * m["hd"]
        nbytes = len(keys) * 2 * q_bytes + sum(keys) * kv_bytes
        total += least_s(flops, nbytes)
    return m["layers"] * total


def boundary_flops(c: dict, b) -> float:
    """Model FLOPs of one boundary's admissions and decode segment."""
    return (sum(prefill_flops(c, s, n) for s, n in b.prefills)
            + sum(decode_flops(c, k0, n) for k0, n in b.decode_rows))
