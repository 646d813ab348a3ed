"""The plain reference against the port on smoke configurations on the
CPU: with float32 products on both sides they agree to rounding, so the
reference computes the port's model (GQA, QKV bias, interleaved RoPE,
the routed experts, tied or untied heads) from the same weights."""

import pytest
import torch

import perfbench_smoke as S
from perfbench.harness import model as M
from perfbench.reference.model import logits_at


def _port_fp32(c, w):
    from repro_torch.models import transformer as T
    from repro_torch.models.api import build_model
    from repro_torch.quant.policy import PrecisionPolicy
    cfg = M.arch_config(c)
    model = build_model(cfg, policy=PrecisionPolicy(default="fp32"),
                        device="cpu")
    params = T.LM(cfg, device="meta")
    params.load_state_dict(w, strict=True, assign=True)
    return model, params


@pytest.mark.parametrize("name", sorted(S.SMOKE_MODELS))
@pytest.mark.parametrize("seed", [0, 2**31 + 1])
def test_reference_equals_port_in_fp32(name, seed):
    c = S.smoke_config(name, act_dtype="float32")
    w = M.make_weights(c, seed, "cpu")
    model, params = _port_fp32(c, w)
    toks = torch.randint(0, int(c["vocab_size"]), (1, 48),
                         generator=torch.Generator().manual_seed(seed % 97))
    got, _ = model.prefill(params, {"tokens": toks})
    ref = logits_at(c, w, toks[0], torch.arange(48))
    assert torch.allclose(got[0].float(), ref, atol=2e-5, rtol=0)
    assert ref.std() > 0.05


@pytest.mark.parametrize("name", sorted(S.SMOKE_MODELS))
def test_served_weights_are_the_benchmarks(name):
    """The port's parameters are the benchmark's tensors, not copies."""
    c = S.smoke_config(name)
    w = M.make_weights(c, 1, "cpu")
    _, params = M.port_model(c, w, "cpu")
    sd = params.state_dict()
    assert set(sd) == set(w)
    assert all(sd[k].data_ptr() == w[k].data_ptr() for k in w)


def test_port_refuses_what_it_cannot_run():
    c = S.smoke_config("granite-moe-1b-a400m")
    c["residual_multiplier"] = 0.22
    with pytest.raises(ValueError, match="residual_multiplier"):
        M.arch_config(c)
