"""The port's encoder-decoder family (whisper) against the JAX package on
the CPU, at ``whisper-smoke`` (2 + 2 layers, d_model 64, 4 heads, 16
frames): the sinusoid table, the cross-attention branch of
``attention``, the encoder, the uncached decoder and the loss, the
cached prefill and decode steps leaf by leaf, ``generate``'s greedy
tokens under the bf16 and int8-mlp policies, the linears the int8-mlp
rule reaches, whisper-small's size, and the entry points.

Inputs come from numpy seeds (the frames are the reference's stub:
random post-conv embeddings scaled by 0.1); parameters are the JAX
package's init, moved with ``params_from_jax``, and its LayerNorm biases
and scales made non-constant.  The JAX side runs as
``tests/test_models_smoke.py`` runs it (no Pallas kernel on this path).
Tolerances:
- ``sinusoid_positions`` bit-equal, the clamp past the table's last row
  included;
- fp32 activations under the FP32 policy: outputs, logits and fp32
  cache leaves within 1e-4 (fp32 sums in other orders; the port's
  chunked attention stops at the last frame where the reference pads
  the chunk with masked slots), the loss within 1e-5;
- a bf16 cache: its leaves within one bf16 ulp of the largest (both
  packages round the same fp32 values to bf16, which lie an fp32
  rounding apart);
- greedy tokens equal, on prompts whose every step keeps a top-2 gap of
  at least 0.05 (asserted on the port's side).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import common as JC
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.api import build_model as jax_build
from repro.quant.policy import PrecisionPolicy as JaxPolicy
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import whisper_serve
from repro_torch.launch.serve import generate, serve_policy
from repro_torch.models import common as TC
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.api import build_model
from repro_torch.models.common import Ctx
from repro_torch.quant.policy import PrecisionPolicy
from test_torch_model import _perturb_constant_leaves

ARCH = "whisper_small"
TOL = 1e-4


def _pair(level="fp32", act="float32", int8_mlp=False, embed_scale=1.0):
    """(JAX model, JAX params, port model, port params) at smoke size."""
    jcfg = jax_config(ARCH, smoke=True).replace(act_dtype=act)
    tcfg = get_config(ARCH, smoke=True).replace(act_dtype=act)
    jpol, tpol = JaxPolicy(default=level), PrecisionPolicy(default=level)
    if int8_mlp:
        jpol = jpol.with_rule("*mlp*", "int8")
        tpol = serve_policy(True)
    jm = jax_build(jcfg, policy=jpol)
    tm = build_model(tcfg, tpol, device="cpu")
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    params["embed"] = params["embed"] * np.float32(embed_scale)
    _perturb_constant_leaves(params, np.random.default_rng(3))
    lm = tm.empty_params()
    lm.load_state_dict(params_from_jax(params))
    return jm, jax.tree.map(jnp.asarray, params), tm, lm


@pytest.fixture(scope="module")
def fp32_pair():
    return _pair()


def _frames(cfg, b, seed=2):
    return whisper_serve.stub_frames(b, cfg.n_frames, cfg.d_model,
                                     seed).numpy()


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _err(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float32)
                               - np.asarray(want, np.float32))))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# ---------------------------------------------------------------- pieces
@pytest.mark.parametrize("n,d", [(16, 64), (512, 64), (1500, 768),
                                 (48000, 768)])
def test_sinusoid_positions_bit_equal(n, d):
    got = TC.sinusoid_positions(n, d)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JC.sinusoid_positions(n, d)))
    assert TC.sinusoid_positions(n, d) is got          # cached, not rebuilt


def test_decoder_positions_clamp_past_the_table(fp32_pair):
    """whisper-smoke's decoder table has 16 x 32 = 512 rows: positions
    past 511 read row 511 in both packages (JAX clamps the gather), in
    the uncached decoder over 520 tokens and in decode steps at
    positions 510 to 513."""
    jm, jp, tm, lm = fp32_pair
    cfg = tm.cfg
    assert cfg.n_frames * 32 == 512
    toks = _tokens(cfg, 2, 520)
    frames = _frames(cfg, 2)
    enc = JT.encdec_encode(jm.ctx(), jm.cfg, jp, jnp.asarray(frames))
    jl, _ = JT.encdec_decode(jm.ctx(), jm.cfg, jp, jnp.asarray(toks),
                             enc_out=enc)
    with torch.no_grad():
        tenc = TT.encdec_encode(tm.ctx(), cfg, lm, torch.from_numpy(frames))
        tl, _ = TT.encdec_decode(tm.ctx(), cfg, lm, torch.from_numpy(toks),
                                 enc_out=tenc)
    assert _err(tl, jl) <= TOL
    # a token at position 515 reads the same table row as at 511; the
    # model's own copy of the table is not among its saved tensors
    table = lm.dec_pos
    assert "dec_pos" not in lm.state_dict()
    pos = torch.tensor([511, 515, 519])
    got = table[pos.clamp(max=511)]
    want = np.asarray(JC.sinusoid_positions(512, cfg.d_model))[
        np.minimum(pos.numpy(), 511)]
    np.testing.assert_array_equal(got.numpy(), want)
    batch = {"frames": frames, "tokens": toks[:, :510]}
    jc = jm.init_cache(2, 520, dtype=jnp.float32)[0]
    tc = tm.init_cache(2, 520, torch.float32)
    _, jc = jm.prefill(jp, jax.tree.map(jnp.asarray, batch), cache=jc)
    _, tc = tm.prefill(lm, {k: torch.from_numpy(v) for k, v in
                            batch.items()}, tc)
    for t in range(510, 514):
        tok = toks[:, t:t + 1]
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(lm, tc, torch.from_numpy(tok))
        assert _err(tl, jl) <= TOL, t


@pytest.mark.parametrize("n_frames,mea_bf16,tol", [
    (16, False, 1e-5), (1500, False, 1e-5), (1500, True, 1e-4)])
def test_kv_override_cross_attention_equals_jax(fp32_pair, n_frames,
                                                mea_bf16, tol):
    """The ``kv_override`` branch: never causal, never cached, never
    roped, over K/V expanded to H heads.  At 1,500 frames the reference
    pads the last 1,024-frame chunk with masked slots and the port
    slices it short: fp32 outputs within 1e-5 (values O(1)); with bf16
    operands both round the same values, and a probability an fp32
    rounding apart may round to the neighbouring bf16 value (1e-4)."""
    jm, jp, tm, lm = fp32_pair
    jcfg = jm.cfg.replace(mea_bf16=mea_bf16)
    tcfg = tm.cfg.replace(mea_bf16=mea_bf16)
    rng = np.random.default_rng(4)
    b, s = 2, 3
    x = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    k = rng.standard_normal((b, n_frames, tcfg.n_kv_heads, tcfg.hd)
                            ).astype(np.float32)
    v = rng.standard_normal(k.shape).astype(np.float32)
    positions = np.arange(7, 7 + s)
    lp = jax.tree.map(lambda t: t[0], jp["dec_blocks"])
    want, jcache = JL.attention(
        jm.ctx(decode=True), jcfg, lp["cross"], jnp.asarray(x),
        jnp.asarray(positions),
        kv_override=(jnp.asarray(k), jnp.asarray(v),
                     jnp.arange(n_frames)))
    assert jcache is None
    with torch.no_grad():
        got, tcache = TL.attention(
            tm.ctx(decode=True), tcfg, lm.dec_blocks[0].cross,
            torch.from_numpy(x), torch.from_numpy(positions),
            kv_override=(torch.from_numpy(k), torch.from_numpy(v),
                         torch.arange(n_frames)))
    assert tcache is None
    assert _err(got, want) <= tol


def test_encode_equals_jax(fp32_pair):
    jm, jp, tm, lm = fp32_pair
    frames = _frames(tm.cfg, 3)
    want = JT.encdec_encode(jm.ctx(), jm.cfg, jp, jnp.asarray(frames))
    with torch.no_grad():
        got = TT.encdec_encode(tm.ctx(), tm.cfg, lm, torch.from_numpy(frames))
    assert got.shape == (3, tm.cfg.n_frames, tm.cfg.d_model)
    assert _err(got, want) <= TOL


def test_uncached_decode_and_loss_equal_jax(fp32_pair):
    """The loss path: encoder, then the decoder with the cross K/V
    projected from the encoder's output on the fly."""
    jm, jp, tm, lm = fp32_pair
    cfg = tm.cfg
    frames, toks = _frames(cfg, 2), _tokens(cfg, 2, 12)
    enc = JT.encdec_encode(jm.ctx(), jm.cfg, jp, jnp.asarray(frames))
    jl, jcache = JT.encdec_decode(jm.ctx(), jm.cfg, jp, jnp.asarray(toks),
                                  enc_out=enc)
    with torch.no_grad():
        tenc = TT.encdec_encode(tm.ctx(), cfg, lm, torch.from_numpy(frames))
        tl, tcache = TT.encdec_decode(tm.ctx(), cfg, lm,
                                      torch.from_numpy(toks), enc_out=tenc)
    assert jcache is None and tcache is None
    assert tl.shape == (2, 12, cfg.vocab_size)
    assert _err(tl, jl) <= TOL
    labels = np.roll(toks, -1, axis=1)
    jloss, jm_ = jm.loss(jp, {"frames": jnp.asarray(frames),
                              "tokens": jnp.asarray(toks),
                              "labels": jnp.asarray(labels)})
    tloss, tm_ = tm.loss(lm, {"frames": torch.from_numpy(frames),
                              "tokens": torch.from_numpy(toks),
                              "labels": torch.from_numpy(labels)})
    assert abs(float(tloss) - float(jloss)) <= 1e-5
    assert abs(float(tm_["nll"]) - float(jm_["nll"])) <= 1e-5


def _cache_close(tcache: dict, jcache: dict, tol) -> None:
    """Every leaf — ``self.k``, ``self.v``, ``self.pos``, ``cross_k``,
    ``cross_v`` — of the same shape and dtype and within ``tol`` (of the
    leaf's largest magnitude for a bf16 leaf); ``pos`` equal."""
    assert sorted(tcache) == sorted(jcache) == ["cross_k", "cross_v",
                                                 "self"]
    assert sorted(tcache["self"]) == sorted(jcache["self"]) == ["k", "pos",
                                                                 "v"]
    leaves = [("cross_k", tcache["cross_k"], jcache["cross_k"]),
              ("cross_v", tcache["cross_v"], jcache["cross_v"])]
    leaves += [(f"self.{n}", tcache["self"][n], jcache["self"][n])
               for n in ("k", "v")]
    for name, t, j in leaves:
        want = np.asarray(j.astype(jnp.float32))
        assert tuple(t.shape) == want.shape, name
        assert str(t.dtype).split(".")[-1] == str(j.dtype), name
        bound = tol
        if t.dtype == torch.bfloat16:
            bound = 2.0 ** -8 * float(np.abs(want).max())
        assert _err(_np(t), want) <= bound, name
    np.testing.assert_array_equal(np.asarray(tcache["self"]["pos"]),
                                  np.asarray(jcache["self"]["pos"]))


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_cache_equal_jax(fp32_pair, cache_dtype):
    """``prefill`` (frames encoded into the cross K/V, the prompt into
    the self cache) and 4 ``decode_step`` calls: logits and every cache
    leaf after the prefill and after each step (the port writes into the
    cache it is given); then the JAX cache moved with ``cache_from_jax``
    decodes on the port as on the reference."""
    jm, jp, tm, lm = fp32_pair
    cfg = tm.cfg
    jdt, tdt = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    frames, toks = _frames(cfg, 2), _tokens(cfg, 2, 10)
    jc = jm.init_cache(2, 12, dtype=jdt)[0]
    tc = given = tm.init_cache(2, 12, tdt)
    _cache_close(tc, jc, 0.0)
    jl, jc = jm.prefill(jp, {"frames": jnp.asarray(frames),
                             "tokens": jnp.asarray(toks[:, :6])}, cache=jc)
    tl, tc = tm.prefill(lm, {"frames": torch.from_numpy(frames),
                             "tokens": torch.from_numpy(toks[:, :6])}, tc)
    built = TT.init_encdec_cache(tm.ctx(), cfg, lm, 2, 12,
                                 frames=torch.from_numpy(frames), dtype=tdt)
    for name in ("cross_k", "cross_v"):
        assert tc[name] is given[name], name
        assert torch.equal(built[name], tc[name]), name
    assert tc["self"]["k"] is given["self"]["k"]
    assert _err(tl, jl) <= TOL
    _cache_close(tc, jc, TOL)
    for t in range(6, 10):
        tok = toks[:, t:t + 1]
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(lm, tc, torch.from_numpy(tok))
        assert _err(tl, jl) <= TOL, t
        _cache_close(tc, jc, TOL)
    moved = cache_from_jax(jax.tree.map(np.asarray, jc))
    _cache_close(moved, jc, 0.0)
    tok = np.asarray(jnp.argmax(jl[:, -1:], axis=-1)).astype(np.int32)
    jl, _ = jm.decode_step(jp, jc, jnp.asarray(tok))
    tl, _ = tm.decode_step(lm, moved, torch.from_numpy(tok))
    assert _err(tl, jl) <= TOL


def _jax_generate(jm, jp, frames, prompts, gen, cache_len):
    """The JAX package's greedy enc-dec loop (``examples/whisper_serve.py``
    with a prompt): prefill, then ``decode_step`` on each argmax."""
    jc = jm.init_cache(prompts.shape[0], cache_len)[0]
    logits, jc = jm.prefill(jp, {"frames": jnp.asarray(frames),
                                 "tokens": jnp.asarray(prompts)}, cache=jc)
    out = []
    for step in range(gen):
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        out.append(np.asarray(tok))
        if step < gen - 1:
            logits, jc = jm.decode_step(jp, jc, tok)
    return np.concatenate(out, axis=1)


def _min_top2_gap(tm, lm, frames, prompts, gen, cache_len) -> float:
    logits, cache = tm.prefill(lm, {"frames": torch.from_numpy(frames),
                                    "tokens": torch.from_numpy(prompts)},
                               tm.init_cache(prompts.shape[0], cache_len))
    gaps = []
    for step in range(gen):
        top = torch.topk(logits[:, -1].float(), 2, dim=-1).values
        gaps.append(float((top[:, 0] - top[:, 1]).min()))
        if step < gen - 1:
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            logits, cache = tm.decode_step(lm, cache, tok)
    return min(gaps)


@pytest.mark.parametrize("int8,seed", [(False, 0), (True, 0)])
def test_generate_tokens_equal_jax(int8, seed):
    """Greedy tokens of the port's ``generate`` (device loop and host
    loop, a bf16 cache) against the JAX package's loop, fp32 activations
    under the bf16 policy and under the int8-mlp policy (``mlp/w_up`` and
    ``mlp/w_down`` of both stacks take the int8 product).  The smoke
    model's tied head reads the 0.02-scale embedding, whose logits lie
    too close for a greedy step to be decided: both sides' embedding is
    scaled by 10."""
    jm, jp, tm, lm = _pair("bf16", int8_mlp=int8, embed_scale=10.0)
    cfg = tm.cfg
    frames = _frames(cfg, 2)
    prompts = _tokens(cfg, 2, 4, seed)
    gen, cache_len = 8, 4 + 8 + 1
    want = _jax_generate(jm, jp, frames, prompts, gen, cache_len)
    assert _min_top2_gap(tm, lm, frames, prompts, gen, cache_len) >= 0.05
    for scan in (True, False):
        got = generate(tm, lm, torch.from_numpy(prompts), gen, cache_len,
                       scan=scan, frames=torch.from_numpy(frames))
        assert got.dtype == torch.int32 and got.shape == (2, gen)
        np.testing.assert_array_equal(got.numpy(), want)


def test_int8_mlp_rule_reaches_the_same_linears(monkeypatch):
    """Under the int8-mlp policy, the ``linear`` names of one prefill and
    one decode step, each with its level: the same set in both packages,
    and int8 only at the encoder's and the decoder's ``mlp/w_up`` and
    ``mlp/w_down``."""
    jm, jp, tm, lm = _pair("bf16", int8_mlp=True)
    seen = {"jax": set(), "torch": set()}

    def spy(side, fn):
        def call(ctx, name, *args, **kw):
            seen[side].add((name, ctx.level_for(name)))
            return fn(ctx, name, *args, **kw)
        return call

    for mod in (JL, JT):
        monkeypatch.setattr(mod, "linear", spy("jax", mod.linear))
    for mod in (TL, TT):
        monkeypatch.setattr(mod, "linear", spy("torch", mod.linear))
    cfg = tm.cfg
    frames, toks = _frames(cfg, 2), _tokens(cfg, 2, 3)
    jc = jm.init_cache(2, 5)[0]
    _, jc = jm.prefill(jp, {"frames": jnp.asarray(frames),
                            "tokens": jnp.asarray(toks)}, cache=jc)
    jm.decode_step(jp, jc, jnp.asarray(toks[:, :1]))
    _, tc = tm.prefill(lm, {"frames": torch.from_numpy(frames),
                            "tokens": torch.from_numpy(toks)},
                       tm.init_cache(2, 5))
    tm.decode_step(lm, tc, torch.from_numpy(toks[:, :1]))
    assert seen["torch"] == seen["jax"]
    assert {n for n, level in seen["torch"] if level == "int8"} == \
        {"mlp/w_up", "mlp/w_down"}


# ------------------------------------------------------------ structure
def test_whisper_small_full_size_on_meta():
    """whisper-small at full size, shape-only: 12 + 12 layers, d_model
    768, d_ff 3,072, vocab 51,865 (unpadded, tied), ≈ 2.38e8 fp32
    parameters; and the empty cache's shapes."""
    cfg = get_config(ARCH)
    m = TT.EncDec(cfg, device="meta")
    assert len(m.enc_blocks) == 12 and len(m.dec_blocks) == 12
    assert m.embed.shape == (51865, 768) and m.embed.dtype == torch.float32
    assert m.dec_blocks[0].cross.wq.shape == (768, 768)
    assert m.enc_blocks[0].mlp.w_up.shape == (768, 3072)
    assert not hasattr(m.enc_blocks[0], "cross")
    assert 2.3e8 < sum(p.numel() for p in m.parameters()) < 2.45e8
    cache = TT.init_encdec_cache(Ctx(), cfg, None, 8, 68, device="meta")
    assert cache["cross_k"].shape == (12, 8, 1500, 12, 64)
    assert cache["cross_k"].numel() * 2 * 2 // 8 == 55_296_000
    assert cache["self"]["k"].shape == (12, 8, 68, 12, 64)
    assert build_model(cfg, device="cpu").cfg is cfg


def test_serve_cli_refuses_enc_dec():
    with pytest.raises(SystemExit) as err:
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    assert "repro_torch.launch.whisper_serve" in str(err.value)


def test_whisper_serve_entry_point_on_cpu(capsys):
    assert whisper_serve.main(["--device", "cpu", "--batch", "2",
                               "--gen", "5"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == "whisper-smoke" and out["device"] == "cpu"
    assert out["generated"] == 5 and out["frames"] == 16
    assert all(0 <= t < 256 for t in out["sample"])
    assert out["cross_kv_bytes_per_request"] == 2 * 16 * 2 * 4 * 16 * 2


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_registry_config_builds(arch):
    """Every registry config builds through ``build_model(...,
    device="cpu")`` (none is refused now): at full size shape-only on
    the meta device, at smoke size with its weights drawn and one
    forward of finite logits."""
    full = get_config(arch)
    params = build_model(full, device="meta").empty_params()
    assert sum(p.numel() for p in params.parameters()) > 0
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, device="cpu")
    lm = model.init(seed=0)
    toks = torch.from_numpy(_tokens(cfg, 1, 4))
    batch = {"tokens": toks, "labels": toks}
    if cfg.enc_dec:
        batch["frames"] = torch.from_numpy(_frames(cfg, 1))
    loss, _ = model.loss(lm, batch)
    assert torch.isfinite(loss)
