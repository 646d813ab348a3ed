"""The work counts against brute-force counts at smoke shapes: the
reference's matrix products counted by ``FlopCounterMode``, the causal
pairs and the kernels' bytes enumerated one by one."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import perfbench_smoke as S
from perfbench.harness import model as M
from perfbench.harness import work as W
from perfbench.reference.model import logits_at

CONFIGS = sorted(S.SMOKE_MODELS)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("s", [1, 9, 40])
def test_prefill_flops_match_the_reference_products(name, s):
    """The reference's counted products over an s-token sequence read at
    its last position: the projections of s tokens (active experts and
    router only), the lm_head once, and the s x s attention scores and
    sums its one block of queries computes (all pairs, which the
    causal count halves)."""
    c = S.smoke_config(name)
    w = M.make_weights(c, 5, "cpu")
    toks = torch.randint(0, int(c["vocab_size"]), (s,))
    with FlopCounterMode(display=False) as fc:
        logits_at(c, w, toks, torch.tensor([s - 1]))
    m = W.dims(c)
    square = 4 * m["h"] * m["hd"] * m["layers"] * s * s
    want = s * W.linear_flops_per_token(c) + W.head_flops(c) + square
    assert fc.get_total_flops() == want
    causal = W.causal_pairs(0, s) * W.attn_flops_per_pair(c)
    assert W.prefill_flops(c, 0, s) == want - square + causal


def _brute_pairs(shared, suffix):
    return sum(1 for i in range(suffix) for j in range(shared + suffix)
               if j <= shared + i)


@pytest.mark.parametrize("shared,suffix", [(0, 1), (0, 17), (32, 5),
                                           (48, 48)])
def test_causal_and_decode_pairs(shared, suffix):
    assert W.causal_pairs(shared, suffix) == _brute_pairs(shared, suffix)
    keys0, steps = shared + 1, suffix
    assert W.decode_pairs(keys0, steps) == sum(keys0 + t
                                               for t in range(steps))


def test_kernel_least_times_by_enumeration():
    c = S.smoke_config("qwen2-7b")
    m = W.dims(c)
    rows = [(0, 40), (32, 9), (16, 1)]
    q = m["h"] * m["hd"] * 2
    kv = 2 * m["kv"] * m["hd"] * 2
    nbytes = sum(n * q + (s + n) * kv + n * q for s, n in rows)
    flops = sum(_brute_pairs(s, n) for s, n in rows) * 4 * m["h"] * m["hd"]
    assert W.prefill_kernel_least_s(c, rows) == pytest.approx(
        m["layers"] * max(nbytes / 3.35e12, flops / 989e12))
    drows = [(50, 3), (20, 1)]
    total = 0.0
    for t in range(3):
        keys = [k0 + t for k0, n in drows if n > t]
        total += max((len(keys) * 2 * q + sum(keys) * kv) / 3.35e12,
                     sum(keys) * 4 * m["h"] * m["hd"] / 989e12)
    assert W.decode_kernel_least_s(c, drows) == pytest.approx(
        m["layers"] * total)


def test_full_size_counts():
    """Qwen2-7B's projections come to 13.1 GFLOP a token plus 1.09 for the
    lm_head; granite's active experts and router to 0.99 GFLOP a token."""
    q = S.load_json(S.ROOT / "perfbench/configs/qwen2-7b.json")
    g = S.load_json(S.ROOT / "perfbench/configs/granite-moe-1b-a400m.json")
    assert W.linear_flops_per_token(q) == pytest.approx(13.09e9, rel=0.01)
    assert W.head_flops(q) == pytest.approx(1.09e9, rel=0.01)
    assert W.linear_flops_per_token(g) == pytest.approx(
        2 * 24 * (1024 * (2048 + 1024) + 1024 * 32 + 8 * 3 * 1024 * 512))
