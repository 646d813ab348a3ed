"""The port's single-device trainer on the CPU against the JAX package:
gradient compression, the data pipeline, one ``make_train_step`` from one
converted init (plain, microbatched, compressed, int8-mlp), remat, the
loop's failure handling and the launcher.

Inputs come from numpy seeds (``TokenSource``) or from the JAX package's
own train state, converted leaf by leaf (``convert.state_from_jax``).
Tolerances, as found:

- compression: bit-equal to the reference's eager functions (its ``jit``
  multiplies by fl(1/127) where both divide, ROADMAP Queue 3, so the
  train-step comparison below allows for it);
- ``TokenSource``: the same integers;
- one train step in fp32 (fp32 activations and products): loss, nll,
  ppl_proxy and grad_norm rtol 1e-5; each moment leaf within 1e-4 of
  its largest value (1e-5 found); every parameter within 1e-4 (1.4e-5
  found); the residuals within 1e-3 of their largest value (3e-4 found:
  XLA fuses ``gf - q * scale`` into one rounding under ``jit``);
- one train step in the models' bf16 activations (plain, int8-mlp):
  losses and grad_norm rtol 1e-3 (ppl_proxy 1.1e-4 found), the moments
  within 10 % of their largest value (m 2.4 %, v 5.6 % found: a bf16 ulp
  of an activation, or under int8-mlp an activation quantized a step
  apart, moves a gradient) or within 1e-6 (m) and 1e-8 (v) — the K bias's gradient is 0
  in exact arithmetic and noise in both packages (its v 6 % apart, 1.8e-9
  found) — 95 % of the parameters within 1e-4 and every one within
  2·lr (Adam's first step moves a weight by about lr·sign(g), and a
  gradient that is noise in both packages — the K bias's is 0 in exact
  arithmetic — moves it 2·lr apart);
- remat: bit-equal gradients.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten as jax_flatten
from repro.configs.registry import get_config as jax_config
from repro.data import pipeline as jpipe
from repro.models import api as japi
from repro.optim import compression as JC
from repro.optim import optimizers as jopt
from repro.quant.policy import PrecisionPolicy as JaxPolicy
from repro.runtime import train_loop as jtl
from repro_torch.checkpoint.manager import CheckpointManager, _flatten
from repro_torch.checkpoint.manager import _host
from repro_torch.checkpoint.manager import _tensor as _restored
from repro_torch.configs.registry import get_config
from repro_torch.convert import _tensor, state_from_jax, state_to_jax
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import quant_matmul as qmm
from repro_torch.launch import train as tlaunch
from repro_torch.models import api as tapi
from repro_torch.optim import compression as TC
from repro_torch.optim import optimizers as topt
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.runtime import train_loop as ttl

LR = 1e-3
# bf16 steps: absolute floors of the moments' tolerance, for gradients
# that are noise in both packages (the K bias's: 0 in exact arithmetic)
MOMENT_FLOOR = {"m": 1e-6, "v": 1e-8}


# ----------------------------------------------------------- compression
def _grads(case: str):
    rng = np.random.default_rng(7)
    g = (rng.standard_normal((33, 20)) * 0.01).astype(np.float32)
    r = (rng.standard_normal((33, 20)) * 1e-4).astype(np.float32)
    if case == "zeros":
        return np.zeros_like(g), None
    if case == "bf16":
        return np.asarray(jnp.asarray(g, jnp.bfloat16)), r
    return g, (r if case == "residual" else None)


def _torch(a):
    return None if a is None else _tensor(np.asarray(a))


@pytest.mark.parametrize("case", ["plain", "residual", "zeros", "bf16"])
def test_compression_equals_jax_eager(case):
    """quantize/dequantize and compress_with_feedback bit for bit against
    the reference called eagerly; an all-zero grad quantizes to 0 under
    the 1e-12 floor; a bf16 grad comes back bf16 with an fp32 residual."""
    g, r = _grads(case)
    jq, js = JC.quantize_grad(jnp.asarray(g))
    tq, ts = TC.quantize_grad(_torch(g))
    assert torch.equal(tq, torch.from_numpy(np.asarray(jq)))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(
        TC.dequantize_grad(tq, ts).numpy(),
        np.asarray(JC.dequantize_grad(jq, js)))
    jd, jr = JC.compress_with_feedback(
        jnp.asarray(g), None if r is None else jnp.asarray(r))
    td, tr = TC.compress_with_feedback(_torch(g), _torch(r))
    assert td.dtype == _torch(g).dtype and tr.dtype == torch.float32
    assert torch.equal(td, _torch(jd)) and torch.equal(tr, _torch(jr))
    if case == "zeros":
        assert float(ts) == np.float32(1e-12) / np.float32(127.0)
        assert not td.any() and not tr.any()


def test_tree_compression_shares_a_scale_per_stacked_leaf():
    """A list (one stacked JAX leaf, its blocks' tensors) takes one scale:
    the same values as the reference over the stacked leaf; init_residuals
    gives fp32 zeros."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((2, 6, 4)) * np.array([1.0, 0.01])[:, None,
                                                                 None])
    w = w.astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    jd, jr = JC.tree_compress_with_feedback(
        {"blocks": {"w": jnp.asarray(w)}, "b": jnp.asarray(b)}, None)
    tree = {"blocks": {"w": [torch.from_numpy(w[0]), torch.from_numpy(w[1])]},
            "b": torch.from_numpy(b)}
    res = TC.init_residuals(tree)
    assert all(r.dtype == torch.float32 and not r.any()
               for r in topt.tree_leaves(res))
    td, tr = TC.tree_compress_with_feedback(tree, res)
    for i in range(2):
        assert torch.equal(td["blocks"]["w"][i],
                           _torch(jd["blocks"]["w"])[i])
        assert torch.equal(tr["blocks"]["w"][i],
                           _torch(jr["blocks"]["w"])[i])
    assert torch.equal(td["b"], _torch(jd["b"]))
    assert TC.leaf_groups(tree) == [[0], [1, 2]]


# ---------------------------------------------------------- data pipeline
@pytest.mark.parametrize("arch", ["qwen2_7b", "starcoder2_3b"])
def test_token_source_equals_jax(arch):
    vocab = get_config(arch, smoke=True).vocab_size
    js = jpipe.TokenSource(vocab, batch=4, seq_len=32)
    ts = tpipe.TokenSource(vocab, batch=4, seq_len=32)
    for step in range(8):
        a, b = js.batch_at(step), ts.batch_at(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(b["tokens"][:, 1:],
                                      b["labels"][:, :-1])


def test_batcher_prefetch_matches_sync_and_refuses_rules(tmp_path):
    s = tpipe.TokenSource(256, batch=2, seq_len=8)
    sync = tpipe.ShardedBatcher(s, None, prefetch=False, device="cpu")
    pre = tpipe.ShardedBatcher(s, None, prefetch=True, device="cpu")
    for step in (0, 1, 2, 3, 1, 2):     # a restart replays earlier steps
        a, b = sync.get(step), pre.get(step)
        assert a["tokens"].dtype == torch.int64
        assert torch.equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"].numpy(),
                                      s.batch_at(step)["labels"])
    # with rules (one-rank gloo mesh) a batch is a DTensor of the same rows
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import ShardingRules
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        rules = ShardingRules.default(make_host_mesh(1, 1, "cpu"))
        placed = tpipe.ShardedBatcher(s, rules, device="cpu").get(2)
        assert torch.equal(placed["tokens"].full_tensor(),
                           sync.get(2)["tokens"])
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ train step
def _pair(arch: str, mode: str):
    """JAX and port models of ``arch``'s smoke config (fp32 activations
    and an fp32 policy for the fp32 modes), and one train state each: the
    port's converted from the JAX package's."""
    jc, tc = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    jpol = tpol = None
    if mode in ("fp32", "microbatches", "compression"):
        jc, tc = (c.replace(act_dtype="float32") for c in (jc, tc))
        jpol, tpol = JaxPolicy(default="fp32"), PrecisionPolicy(
            default="fp32")
    elif mode == "int8-mlp":
        jpol = JaxPolicy(default="bf16").with_rule("*mlp*", "int8")
        tpol = PrecisionPolicy(default="bf16").with_rule("*mlp*", "int8")
    jm = japi.build_model(jc, policy=jpol) if jpol else japi.build_model(jc)
    tm = tapi.build_model(tc, policy=tpol, device="cpu")
    comp = mode == "compression"
    js = jtl.init_train_state(jm, jopt.adamw(LR), jax.random.PRNGKey(0),
                              grad_compression=comp)
    ts = state_from_jax(jax.tree.map(lambda a: _tensor(np.asarray(a)), js),
                        tm)
    return jm, js, tm, ts


def _flat_np(jstate, tstate):
    """Both train states at their checkpoint paths, as fp32 numpy."""
    jf = {k: np.asarray(v, np.float32) for k, v in
          jax_flatten(jax.tree.map(np.asarray, jstate)).items()}
    tf = {k: _restored(*_host(v)).float().numpy()
          for k, v in _flatten(state_to_jax(tstate)).items()}
    assert sorted(jf) == sorted(tf)
    return jf, tf


@pytest.mark.parametrize("arch,mode", [
    ("qwen2_7b", "fp32"), ("qwen2_7b", "microbatches"),
    ("qwen2_7b", "compression"), ("starcoder2_3b", "bf16"),
    ("starcoder2_3b", "int8-mlp")])
def test_train_step_equals_jax(arch, mode, monkeypatch):
    """One make_train_step from one converted init and one TokenSource
    batch: loss, nll, ppl_proxy, grad_norm, the parameters, m, v (and the
    residuals) against the reference's jitted step."""
    jm, js, tm, ts = _pair(arch, mode)
    kw = {"grad_compression": mode == "compression",
          "microbatches": 2 if mode == "microbatches" else 1}
    batch = tpipe.TokenSource(tm.cfg.vocab_size, 4, 32).batch_at(0)
    jstep = jax.jit(jtl.make_train_step(jm, jopt.adamw(LR), **kw))
    jn, jmet = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
    qmm_calls = []
    orig = qmm.int8_matmul_plain
    monkeypatch.setattr(qmm, "int8_matmul_plain",
                        lambda *a: qmm_calls.append(1) or orig(*a))
    tstep = ttl.make_train_step(tm, topt.adamw(LR), **kw)
    tn, tmet = tstep(ts, {k: torch.from_numpy(v).long()
                          for k, v in batch.items()})
    assert tn is ts and tn["opt"]["step"] == 1
    fp32 = mode in ("fp32", "microbatches", "compression")
    rtol, gtol = (1e-5, 1e-5) if fp32 else (1e-3, 1e-3)
    for k in ("loss", "nll", "ppl_proxy"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=rtol)
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=gtol)
    jf, tf = _flat_np(jn, tn)
    moment_tol = 1e-4 if fp32 else 0.1
    diffs = []
    for k in jf:
        d = np.abs(jf[k] - tf[k])
        top = float(np.abs(jf[k]).max())
        if k.startswith(("opt/m/", "opt/v/")):
            floor = 0.0 if fp32 else MOMENT_FLOOR[k[4]]
            assert d.max() <= moment_tol * top + floor, (k, d.max(), top)
        elif k.startswith("residuals/"):
            assert d.max() <= 1e-3 * top, (k, d.max(), top)
            assert np.abs(tf[k]).max() > 0
        elif k.startswith("params/"):
            diffs.append(d.reshape(-1))
    diffs = np.concatenate(diffs)
    if fp32:
        assert diffs.max() <= 1e-4
    else:
        assert (diffs <= 1e-4).mean() >= 0.95
        assert diffs.max() <= 2 * LR + 1e-6
    # the STE forward ran quant_matmul's plain version once on each MLP
    # product (w_up, w_down) of each layer, and the MLP weights moved
    assert len(qmm_calls) == (2 * tm.cfg.n_layers if mode == "int8-mlp"
                              else 0)
    for name in ("w_up", "w_down"):
        before = np.asarray(js["params"]["blocks"]["mlp"][name], np.float32)
        assert np.abs(tf[f"params/blocks/mlp/{name}"] - before).max() > 0


def test_train_state_has_the_jax_paths_shapes_and_dtypes():
    """init_train_state's checkpoint layout is the reference's: the same
    paths, shapes and dtypes (bf16 parameters included), opt/step an
    int32 scalar."""
    jc = jax_config("starcoder2_3b", smoke=True).replace(
        param_dtype="bfloat16")
    tc = get_config("starcoder2_3b", smoke=True).replace(
        param_dtype="bfloat16")
    js = jtl.init_train_state(japi.build_model(jc), jopt.adamw(LR),
                              jax.random.PRNGKey(0), grad_compression=True)
    ts = ttl.init_train_state(tapi.build_model(tc, device="cpu"),
                              topt.adamw(LR), 0, grad_compression=True)
    want = {k: (tuple(np.shape(v)), str(np.asarray(v).dtype))
            for k, v in jax_flatten(js).items()}
    got = {}
    for k, v in _flatten(state_to_jax(ts)).items():
        arr, dtype = _host(v)
        got[k] = (tuple(arr.shape), dtype)
    assert got == want
    assert want["params/embed"][1] == "bfloat16"
    assert want["opt/step"] == ((), "int32")


# ----------------------------------------------------------------- remat
def _remat_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab_size, (2, 17))
    batch = {"tokens": torch.from_numpy(t[:, :-1]),
             "labels": torch.from_numpy(t[:, 1:])}
    if cfg.enc_dec:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_frames, cfg.d_model)).astype(np.float32))
    return batch


def _remat_grads(arch, remat, policy=None):
    cfg = get_config(arch, smoke=True).replace(remat=remat)
    model = tapi.build_model(cfg, policy=policy, device="cpu")
    params = model.init(0)
    leaves = [p.requires_grad_(True) for p in params.parameters()]
    loss, _ = model.loss(params, _remat_batch(cfg))
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("remat", ["full", "dots", "dots+moe"])
@pytest.mark.parametrize("arch", ["starcoder2_3b", "granite_moe_1b_a400m",
                                  "zamba2_2p7b", "xlstm_125m",
                                  "whisper_small"])
def test_remat_gradients_bit_equal(arch, remat):
    """Every family's stacks (dense, MoE, hybrid, xLSTM, the enc-dec
    encoder and decoder) give the same loss and gradients, bit for bit,
    under each remat policy as without it."""
    l0, g0 = _remat_grads(arch, "none")
    l1, g1 = _remat_grads(arch, remat)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("remat,per_product", [("none", 1), ("dots", 1),
                                               ("full", 2)])
def test_remat_dots_keeps_the_int8_product(remat, per_product, monkeypatch):
    """Under int8-mlp the int8 product (the op around quant_matmul's
    launch) runs once a product a step under "none" and "dots" — "dots"
    keeps its output — and twice under "full" (recomputed in the
    backward); the gradients are equal."""
    calls = []
    orig = qmm.int8_matmul_plain
    monkeypatch.setattr(qmm, "int8_matmul_plain",
                        lambda *a: calls.append(1) or orig(*a))
    policy = PrecisionPolicy(default="bf16").with_rule("*mlp*", "int8")
    _, g = _remat_grads("starcoder2_3b", remat, policy)
    n_layers = get_config("starcoder2_3b", smoke=True).n_layers
    assert len(calls) == 2 * n_layers * per_product
    monkeypatch.setattr(qmm, "int8_matmul_plain", orig)
    _, g0 = _remat_grads("starcoder2_3b", "none", policy)
    assert all(torch.equal(a, b) for a, b in zip(g0, g))


def test_remat_is_off_without_autograd():
    """The cached paths (no autograd) and a block whose input and
    parameters need no grad run as they are; with autograd recording the
    block runs again in the backward."""
    from repro_torch.models import transformer as T
    cfg = get_config("starcoder2_3b", smoke=True).replace(remat="full")
    ran = []

    def fn(x):
        ran.append(torch.is_grad_enabled())
        return torch.sin(torch.sin(x))
    wrapped = T._remat(cfg, fn)
    x = torch.linspace(-1.0, 1.0, 5, requires_grad=True)
    with torch.no_grad():
        assert torch.equal(wrapped(x), fn(x))
    assert ran == [False, False]
    wrapped(x.detach())                    # nothing to record
    assert ran == [False, False, True]
    wrapped(x).sum().backward()
    assert ran == [False, False, True, True, True]
    assert torch.equal(x.grad, torch.cos(torch.sin(x)) * torch.cos(x))


# ------------------------------------------------------------------ loop
class _Batcher:
    """A batcher that raises ``error`` once, at ``at``."""

    def __init__(self, inner, at, error):
        self.inner, self.at, self.error = inner, at, error

    def get(self, step):
        if step == self.at and self.error is not None:
            err, self.error = self.error, None
            raise err
        return self.inner.get(step)


def _loop(tmp_path, **kw):
    cfg = get_config("qwen2_7b", smoke=True)
    model = tapi.build_model(cfg, device="cpu")
    src = tpipe.TokenSource(cfg.vocab_size, batch=2, seq_len=16)
    batcher = kw.pop("batcher", None) or tpipe.ShardedBatcher(
        src, None, prefetch=False, device="cpu")
    return ttl.train_loop(model, steps=6, batcher=batcher,
                          ckpt=CheckpointManager(str(tmp_path)),
                          optimizer=topt.adamw(LR), ckpt_every=3, **kw)


def test_node_failure_restarts_and_other_errors_propagate(tmp_path):
    """An injected NodeFailure restarts from the last checkpoint (steps 3
    and 4 run twice) and the losses equal an uninterrupted run's; a
    RuntimeError that is not a NodeFailure (a CUDA error, an OOM, a kernel
    that fails to launch) reaches the caller."""
    r0 = _loop(tmp_path / "a")
    r1 = _loop(tmp_path / "b", injector=ttl.FailureInjector((5,)))
    assert issubclass(ttl.NodeFailure, RuntimeError)
    assert (r0.restarts, r1.restarts) == (0, 1)
    assert r1.steps_run == 6 + 2
    assert r1.losses[:5] == r0.losses[:5]
    assert r1.losses[5:] == r0.losses[3:]
    src = tpipe.TokenSource(256, batch=2, seq_len=16)
    inner = tpipe.ShardedBatcher(src, None, prefetch=False, device="cpu")
    with pytest.raises(RuntimeError, match="device fault"):
        _loop(tmp_path / "c", batcher=_Batcher(
            inner, 2, RuntimeError("device fault")))
    r2 = _loop(tmp_path / "d", batcher=_Batcher(
        inner, 2, ttl.NodeFailure("lost")))
    assert r2.restarts == 1 and r2.losses == r0.losses[:2] + r0.losses


def test_launch_train_main_restarts_once(tmp_path, capsys):
    rc = tlaunch.main(["--arch", "starcoder2_3b", "--smoke", "--device",
                       "cpu", "--steps", "6", "--ckpt-every", "3",
                       "--batch", "2", "--seq-len", "16",
                       "--inject-failures", "4", "--mesh", "2x1",
                       "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"):])
    assert rc == 0
    assert report["restarts"] == 1 and report["steps_run"] == 6 + 1
    assert report["devices"] == 1 and report["arch"] == "starcoder2-smoke"
    assert np.isfinite(report["final_loss"])
    assert CheckpointManager(str(tmp_path)).committed_steps() == [-1, 2, 5]


def test_mesh_clamps_as_jax_and_a_mesh_waits(tmp_path, capsys):
    """--mesh is clamped to the devices there are, as the reference's
    make_host_mesh clamps it; under a process group the clamped mesh
    trains (it no longer waits)."""
    from repro.launch.mesh import make_host_mesh
    n = len(jax.devices())
    for data, model in [(1, 1), (2, 4), (4, 1), (3, 3)]:
        assert tlaunch.host_mesh_shape(data, model, n) == \
            make_host_mesh(data, model).devices.shape
    assert tlaunch.host_mesh_shape(2, 4, 4) == (2, 2)
    assert tlaunch.host_mesh_shape(4, 1, 2) == (2, 1)
    # a mesh no longer waits: --mesh 2x1 on a one-rank world clamps to
    # 1 x 1 and trains on it (the 4-rank run: tests/test_torch_sharding.py)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        tlaunch.main(["--arch", "qwen2_7b", "--smoke", "--device", "cpu",
                      "--mesh", "2x1", "--steps", "2",
                      "--ckpt-dir", str(tmp_path / "ckpt")])
    finally:
        dist.destroy_process_group()
    out = capsys.readouterr().out
    assert json.loads(out[out.index("{"):])["mesh"] == [1, 1]
