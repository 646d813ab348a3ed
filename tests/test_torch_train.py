"""The port's training substrate on the CPU against the JAX package: the
optimizers and schedules, the INT8 straight-through product, the losses
and a few training steps of ``train_classifier`` and ``lm_finetune``.

Inputs come from numpy seeds or from the JAX package's own parameters,
converted (``convert.py``).  Tolerances, as found:

- optimizers, schedules, clipping: fp32, rtol 1e-6 (atol 1e-9) — the same
  operations in the same order; XLA's fused kernels and torch's eager
  ones round a few elements an ulp apart;
- the STE product: forward bit-equal to ``quant_matmul_plain`` and to the
  JAX eager ``_int8_mm_ste``; under ``jit`` XLA multiplies by fl(1/127)
  where both divide (ROADMAP Queue 3), so a few activations quantize one
  step apart: within one quantization step of the output; gradients fp32
  rtol 1e-5;
- losses: fp32 logits rtol 1e-6; the LM's loss, nll and ppl_proxy rtol
  1e-3 (its logits are bf16: one bf16 ulp of a logit moves the nll by
  ~1e-4);
- training steps: the bench MLP in fp32 within 1e-6 after 3 steps; under
  INT8 within 1e-5; ResNet9's convolutions (fp32) within 2e-4 after 4
  steps (3 of 36,864 weights past 1e-5); an LM (bf16 products) within
  2e-3 of loss, 95 % of the parameters within 1e-4 after 2-3 steps (97 %
  found) and every one within 2·lr·steps — Adam's first steps move every
  weight by about lr·sign(g), so a gradient that is noise in both packages
  (the K bias's is 0 in exact arithmetic) moves its weight 2·lr apart;
  the trained LM's next-token accuracy within 2 of its 1,024 tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.core.metamodel import MetaModel as JaxMeta
from repro.models import api as japi
from repro.models import cnn as jcnn
from repro.models import common as jcommon
from repro.optim import optimizers as jopt
from repro.quant.policy import PrecisionPolicy as JaxPolicy
from repro.sparsity import masks as jmasks
from repro.tasks import train_utils as jtu
from repro.tasks.model_gen import ModelGen as JaxModelGen
from repro_torch.configs.registry import get_config
from repro_torch.convert import bench_params_from_jax, params_from_jax
from repro_torch.core.metamodel import MetaModel
from repro_torch.data import synthetic
from repro_torch.kernels.quant_matmul import quant_matmul_plain
from repro_torch.models import api as tapi
from repro_torch.models import cnn as tcnn
from repro_torch.models.common import Ctx, Int8MatmulSTE, linear
from repro_torch.optim import optimizers as topt
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.sparsity import masks as tmasks
from repro_torch.tasks import train_utils as ttu
from repro_torch.tasks.model_gen import ModelGen


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tree(seed: int, dtype=np.float32):
    """A nested tree with a matrix, a vector, a conv kernel and a nested
    dict, keys unsorted (the pytree order sorts them)."""
    rng = np.random.default_rng(seed)
    return {"zeta": rng.standard_normal((6, 5)).astype(dtype),
            "alpha": {"w": rng.standard_normal((3, 3, 2, 4)).astype(dtype),
                      "b": rng.standard_normal((4,)).astype(dtype)},
            "mid": rng.standard_normal((7,)).astype(dtype)}


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            topt.tree_map(torch.from_numpy, tree))


def _close(jtree, ttree, rtol=1e-6, atol=1e-9):
    jl = jax.tree.leaves(jtree)
    tl = topt.tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32),
                                   rtol=rtol, atol=atol)


# ------------------------------------------------------------ optimizers
def test_tree_leaves_follow_the_jax_pytree_order():
    tree = _tree(0)
    jl = jax.tree.leaves(tree)
    tl = topt.tree_leaves(tree)
    assert [a.shape for a in jl] == [b.shape for b in tl]
    assert all(a is b for a, b in zip(jl, tl))
    back = topt.tree_unflatten(tree, tl)
    assert topt.tree_leaves(back) == tl


def test_lm_per_block_tree_follows_the_jax_pytree():
    """The tree LM training updates: the JAX pytree's leaves in its order,
    each stacked block leaf as the blocks' own parameters (no view)."""
    _, jp, _, tp = _lm_pair()
    tree = tp.param_tree(per_block=True)
    got = topt.tree_leaves(tree)
    want = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        a = np.asarray(leaf)
        want += list(a) if path[0].key == "blocks" else [a]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, torch.nn.Parameter)
        np.testing.assert_array_equal(g.detach().numpy(), w)
    assert {id(p) for p in got} == {id(p) for p in tp.parameters()}


def test_polynomial_schedule_equals_jax():
    for final in (0.5, 0.9375):
        for step in range(-1, 12):
            assert tmasks.polynomial_schedule(step, 0, 8, final) == \
                jmasks.polynomial_schedule(step, 0, 8, final)


@pytest.mark.parametrize("kind", ["constant", "cosine"])
def test_schedules_equal_jax(kind):
    if kind == "constant":
        js, ts = jopt.constant_schedule(3e-3), topt.constant_schedule(3e-3)
    else:
        js = jopt.cosine_schedule(1e-3, 5, 40, final_frac=0.1)
        ts = topt.cosine_schedule(1e-3, 5, 40, final_frac=0.1)
    for step in range(0, 46):
        want = float(js(jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(ts(step), want, rtol=1e-6, atol=0)


def test_global_norm_and_clipping_equal_jax():
    jt, tt = _both(_tree(1))
    np.testing.assert_allclose(float(topt.global_norm(tt)),
                               float(jopt.global_norm(jt)), rtol=1e-6)
    for max_norm in (0.5, 1e3):
        jc, jn = jopt.clip_by_global_norm(jt, max_norm)
        tc, tn = topt.clip_by_global_norm(tt, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _close(jc, tc)
    # bf16 leaves come back in bf16
    tb = topt.tree_map(lambda t: t.to(torch.bfloat16), tt)
    cb, _ = topt.clip_by_global_norm(tb, 0.5)
    assert all(t.dtype == torch.bfloat16 for t in topt.tree_leaves(cb))


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("sched", ["constant", "cosine"])
def test_adamw_updates_equal_jax(weight_decay, sched):
    lr = (1e-2 if sched == "constant"
          else (jopt.cosine_schedule(1e-2, 2, 6),
                topt.cosine_schedule(1e-2, 2, 6)))
    jo = jopt.adamw(lr if sched == "constant" else lr[0],
                    weight_decay=weight_decay)
    to = topt.adamw(lr if sched == "constant" else lr[1],
                    weight_decay=weight_decay)
    jp, tp = _both(_tree(2))
    js, ts = jo.init(jp), to.init(tp)
    for step in range(4):
        jg, tg = _both(_tree(10 + step))
        ju, js = jo.update(jg, js, jp)
        tu, ts = to.update(tg, ts, tp)
        _close(ju, tu)
        _close(js["m"], ts["m"])
        _close(js["v"], ts["v"])
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        _close(jp, tp)
    assert ts["step"] == int(js["step"]) == 4
    # the decay reaches only leaves of ndim >= 2, as in the JAX package
    z = topt.tree_map(torch.zeros_like, tp)
    u, _ = topt.adamw(1e-2, weight_decay=weight_decay).update(
        z, topt.adamw(1e-2).init(tp), tp)
    assert torch.count_nonzero(u["mid"]) == 0
    assert (torch.count_nonzero(u["zeta"]) > 0) == (weight_decay > 0)


def test_adamw_keeps_fp32_moments_for_bf16_params():
    tree = topt.tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16),
                         _tree(3))
    jtree = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), _tree(3))
    to, jo = topt.adamw(1e-3), jopt.adamw(1e-3)
    ts, js = to.init(tree), jo.init(jtree)
    assert all(m.dtype == torch.float32 for m in topt.tree_leaves(ts["m"]))
    grads = topt.tree_map(lambda t: t * 0.5, tree)
    jgrads = jax.tree.map(lambda t: t * 0.5, jtree)
    tu, ts = to.update(grads, ts, tree)
    ju, js = jo.update(jgrads, js, jtree)
    _close(ju, tu)
    new, jnew = topt.apply_updates(tree, tu), jopt.apply_updates(jtree, ju)
    assert all(t.dtype == torch.bfloat16 for t in topt.tree_leaves(new))
    for a, b in zip(jax.tree.leaves(jnew), topt.tree_leaves(new)):
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a, np.float32))


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_updates_equal_jax(momentum):
    jo, to = jopt.sgd(0.1, momentum), topt.sgd(0.1, momentum)
    jp, tp = _both(_tree(4))
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        jg, tg = _both(_tree(20 + step))
        ju, js = jo.update(jg, js)
        tu, ts = to.update(tg, ts)
        _close(ju, tu)
    assert sorted(ts) == sorted(js)


# ------------------------------------------------------------ STE product
@pytest.mark.parametrize("shape", [(7, 16, 5), (33, 64, 10), (2, 3, 40)])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_int8_ste_forward_and_gradients_equal_jax(shape, dtype):
    m, k, n = shape
    rng = np.random.default_rng(m * k * n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (0.3 * rng.standard_normal((k, n))).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    jdt = jnp.float32 if dtype is np.float32 else jnp.bfloat16
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(tdt)
    tw = torch.tensor(np.asarray(jw.astype(jnp.float32))).to(tdt)
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    y = Int8MatmulSTE.apply(tx, tw)
    # the forward is the kernel's plain version, bit for bit, and the JAX
    # eager product (which divides as the port does)
    assert torch.equal(y.detach(), quant_matmul_plain(tx.detach(),
                                                      tw.detach()))
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(jcommon._int8_mm_ste(jx, jw)))
    # under jit within one quantization step: |dy| <= xs * ws * sum|wq|
    jit_y = np.asarray(jax.jit(jcommon._int8_mm_ste)(jx, jw))
    xs = np.abs(x).max(1, keepdims=True) / 127
    ws = np.abs(w).max(0, keepdims=True) / 127
    bound = xs * ws * 127 * k
    assert np.all(np.abs(jit_y - y.detach().numpy()) <= bound)
    # straight-through gradients, as jax.grad through _int8_mm_bwd
    (y.float() * torch.from_numpy(g)).sum().backward()
    jgx, jgw = jax.grad(lambda a, b: jnp.sum(
        jcommon._int8_mm_ste(a, b) * g), argnums=(0, 1))(jx, jw)
    assert tx.grad.dtype == tdt and tw.grad.dtype == tdt
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.asarray(jgx, np.float32), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tw.grad.float().numpy(),
                               np.asarray(jgw, np.float32), rtol=1e-5,
                               atol=1e-6)
    # = the fp32 products of _int8_mm_bwd, rounded once to w's dtype (an
    # ulp of it apart where numpy sums in another order)
    want = torch.from_numpy(tx.detach().float().numpy().T @ g).to(tdt)
    rtol = 1e-5 if tdt == torch.float32 else 8e-3
    torch.testing.assert_close(tw.grad.float(), want.float(), rtol=rtol,
                               atol=1e-6)


def test_int8_linear_trains_through_leading_axes():
    """linear under an INT8 policy on (B, S, K) activations: the forward
    is quant_matmul's, the gradients those of the full-precision
    product."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    b = torch.zeros(8)
    x.requires_grad_(True)
    w.requires_grad_(True)
    ctx = Ctx(policy=PrecisionPolicy(default="int8"))
    y = linear(ctx, "fc", x, w, b)
    assert y.grad_fn is not None and y.shape == (2, 3, 8)
    assert torch.equal(y.detach(), quant_matmul_plain(
        x.detach().reshape(6, 16), w.detach()).reshape(2, 3, 8))
    y.sum().backward()
    ones = torch.ones((6, 8))
    torch.testing.assert_close(w.grad, x.detach().reshape(6, 16).T @ ones)
    torch.testing.assert_close(x.grad,
                               (ones @ w.detach().T).reshape(2, 3, 16))


# --------------------------------------------------------------- losses
def test_softmax_xent_equals_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((64, 10)).astype(np.float32) * 3
    labels = rng.integers(0, 10, 64).astype(np.int32)
    want = float(jtu.softmax_xent(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(ttu.softmax_xent(torch.from_numpy(logits),
                                 torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _lm_pair(**replace):
    """JAX and port qwen2-smoke models (config ``replace``d alike) and
    parameters, the port's converted from the JAX init."""
    jcfg = jax_config("qwen2_7b", smoke=True).replace(**replace)
    tcfg = get_config("qwen2_7b", smoke=True).replace(**replace)
    jm, tm = japi.build_model(jcfg), tapi.build_model(tcfg, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    tp = tm.empty_params()
    tp.load_state_dict(params_from_jax(_np(jp)))
    return jm, jp, tm, tp


def _lm_batch(vocab: int, seed: int, b: int = 2, s: int = 32):
    t = synthetic.lm_tokens(b * s + 1, vocab, seed=seed)
    return {"tokens": t[:-1].reshape(b, s), "labels": t[1:].reshape(b, s)}


@pytest.mark.parametrize("pad,chunk", [(0, 0), (96, 16), (0, 12)])
def test_lm_loss_equals_jax(pad, chunk):
    """LMModel.loss: padded vocab columns masked to -1e30, loss_chunk
    tokens at a time (12 does not divide 32: one shot), the z-loss, nll
    and ppl_proxy; and the loss differentiates."""
    jm, jp, tm, tp = _lm_pair(pad_vocab_to_multiple=pad, loss_chunk=chunk)
    if pad:
        assert tp.embed.shape[0] == 288 > tm.cfg.vocab_size
    batch = _lm_batch(tm.cfg.vocab_size, 3)
    jl, jaux = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, taux = tm.loss(tp, ttu.lm_batch(batch, "cpu"))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
    for key in ("nll", "ppl_proxy"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   rtol=1e-3)
    # the padded columns take no probability: the same loss as unpadded
    if pad:
        _, _, um, up = _lm_pair(loss_chunk=chunk)
        with torch.no_grad():
            up.load_state_dict({k: v[:256] if k == "embed" else
                                v[:, :256] if k == "lm_head" else v
                                for k, v in tp.state_dict().items()})
        np.testing.assert_allclose(
            float(um.loss(up, ttu.lm_batch(batch, "cpu"))[0]), float(tl),
            rtol=1e-5)
    tp.lm_head.requires_grad_(True)
    loss, _ = tm.loss(tp, ttu.lm_batch(batch, "cpu"))
    loss.backward()
    assert tp.lm_head.grad is not None
    if pad:
        # no gradient reaches the padded columns' logits
        assert torch.count_nonzero(tp.lm_head.grad[:, 256:]) == 0


# ---------------------------------------------------------- train steps
def _jet(policy: str):
    jp = jcnn.init_jet_dnn(jax.random.PRNGKey(0))
    x, y = synthetic.jet_dataset(3 * 128, seed=1)
    return jp, bench_params_from_jax(_np(jp)), (x, y), policy


@pytest.mark.parametrize("policy,mode,tol", [
    ("fp32", "plain", 1e-6), ("fp32", "schedule", 1e-6),
    ("int8", "plain", 1e-5), ("bf16", "masks", 1e-5)])
def test_train_classifier_steps_equal_jax(policy, mode, tol):
    """3 steps of train_classifier on jet_dnn from one init and the same
    batches: plain, with a polynomial mask schedule, under INT8 (the STE
    product), and with fixed masks under bf16."""
    jp, tp, data, _ = _jet(policy)
    paths = jmasks.prunable_paths(jp, min_size=64)
    kw_j, kw_t = {}, {}
    if mode == "schedule":
        kw_j["mask_schedule"] = lambda s: jmasks.build_masks(
            jp, jmasks.polynomial_schedule(s, 0, 2, 0.5), "unstructured",
            paths)
        kw_t["mask_schedule"] = lambda s: tmasks.build_masks(
            tp, tmasks.polynomial_schedule(s, 0, 2, 0.5), "unstructured",
            paths)
    elif mode == "masks":
        kw_j["masks"] = jmasks.build_masks(jp, 0.5, "unstructured", paths)
        kw_t["masks"] = tmasks.build_masks(tp, 0.5, "unstructured", paths)
    jout, jl = jtu.train_classifier(jp, jcnn.jet_dnn_apply, data, epochs=1,
                                    policy=JaxPolicy(default=policy),
                                    seed=3, **kw_j)
    tout, tl = ttu.train_classifier(tp, tcnn.jet_dnn_apply, data, epochs=1,
                                    policy=PrecisionPolicy(default=policy),
                                    seed=3, **kw_t)
    assert len(tl) == len(jl) == 3
    np.testing.assert_allclose(tl, jl, rtol=tol, atol=tol)
    _close(jout, tout, rtol=tol, atol=tol)
    if mode != "plain":
        masks = kw_t.get("masks") or kw_t["mask_schedule"](2)
        for path, m in masks.items():
            layer = tout[path.split("/")[0]]["w"]
            assert torch.count_nonzero(layer[m == 0]) == 0
    # the input parameters are left as they were
    assert torch.equal(tp["fc0"]["w"], bench_params_from_jax(
        _np(jp))["fc0"]["w"])


def test_train_classifier_resnet9_conv_backward_equal_jax():
    """Two steps through the convolutions' backward (ResNet9 at scale
    1/8, 16 images of 32 x 32)."""
    jp = jcnn.init_resnet9(jax.random.PRNGKey(1), scale=0.125)
    tp = bench_params_from_jax(_np(jp))
    x, y = synthetic.svhn_like(16, seed=2)
    jout, jl = jtu.train_classifier(jp, jcnn.resnet9_apply, (x, y),
                                    epochs=2, batch=8,
                                    policy=JaxPolicy(default="fp32"))
    tout, tl = ttu.train_classifier(tp, tcnn.resnet9_apply, (x, y),
                                    epochs=2, batch=8,
                                    policy=PrecisionPolicy(default="fp32"))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _close(jout, tout, rtol=1e-4, atol=2e-4)


def _lm_close(jparams, module, lr: float, steps: int):
    """Adam-step agreement of an LM's parameters: 95 % within 1e-4, every
    one within 2·lr·steps (see the module docstring)."""
    want = params_from_jax(_np(jparams))
    got = module.state_dict()
    assert sorted(got) == sorted(want)
    diffs = torch.cat([(got[k].float() - want[k].float()).abs().reshape(-1)
                       for k in want])
    assert float((diffs <= 1e-4).float().mean()) >= 0.95
    assert float(diffs.max()) <= 2 * lr * steps + 1e-6


@pytest.mark.parametrize("masked", [False, True])
def test_lm_finetune_steps_equal_jax(masked):
    jm, jp, tm, tp = _lm_pair()
    before = {k: v.clone() for k, v in tp.state_dict().items()}
    masks_j = masks_t = None
    if masked:
        jpaths = jmasks.prunable_paths(jp, min_size=64)
        assert jpaths == tmasks.prunable_paths(tp, min_size=64) == \
            ["blocks/attn/bq", "lm_head"]
        masks_j = jmasks.build_masks(jp, 0.3, "unstructured", jpaths)
        masks_t = tmasks.build_masks(tp, 0.3, "unstructured", jpaths)

    def batches(s):
        return _lm_batch(tm.cfg.vocab_size, 100 + s, b=4, s=64)

    jout, jl = jtu.lm_finetune(jm, jp, batches, steps=3, masks=masks_j)
    tout, tl = ttu.lm_finetune(tm, tp, batches, steps=3, masks=masks_t)
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    _lm_close(jout, tout, 1e-3, 3)
    # a trained copy, frozen; the input untouched
    assert tout is not tp
    assert not any(p.requires_grad for p in tout.parameters())
    assert all(torch.equal(v, before[k]) for k, v in tp.state_dict().items())
    if masked:
        head = tout.lm_head
        assert torch.count_nonzero(head[masks_t["lm_head"] == 0]) == 0
        for i, blk in enumerate(tout.blocks):
            bq = blk.attn.bq
            assert torch.count_nonzero(
                bq[masks_t["blocks/attn/bq"][i] == 0]) == 0


# ------------------------------------------------------ MODEL-GEN (train)
def _jax_init_bench(monkeypatch):
    """The port's bench inits draw the JAX package's (same seed)."""
    from repro_torch.models.cnn import BENCH_MODELS
    for name, (jinit, _, _) in jcnn.BENCH_MODELS.items():
        _, apply_fn, info = BENCH_MODELS[name]

        def init(gen, scale=1.0, _j=jinit):
            key = jax.random.PRNGKey(gen.initial_seed())
            return topt.tree_map(lambda t: t.to(gen.device),
                                 bench_params_from_jax(_np(_j(key,
                                                              scale=scale))))
        monkeypatch.setitem(BENCH_MODELS, name, (init, apply_fn, info))


def test_model_gen_trains_bench_model_as_jax(monkeypatch):
    _jax_init_bench(monkeypatch)
    jm = JaxMeta({"ModelGen.train_samples": 512, "ModelGen.train_epochs": 2})
    JaxModelGen(model="jet_dnn").run(jm, [])
    tm = MetaModel({"ModelGen.train_samples": 512,
                    "ModelGen.train_epochs": 2})
    ModelGen(model="jet_dnn", device="cpu").run(tm, [])
    (jt,), (tt,) = jm.trace("model_gen.train"), tm.trace("model_gen.train")
    np.testing.assert_allclose(tt["final_loss"], jt["final_loss"],
                               rtol=1e-5)
    ja, ta = jm.latest("dnn"), tm.latest("dnn")
    assert ta.metrics == ja.metrics
    _close(ja.payload.params, ta.payload.params, rtol=1e-5, atol=1e-6)


def test_model_gen_trains_lm_as_jax(monkeypatch):
    def init(self, seed=0):
        jcfg = jax_config("qwen2_7b", smoke=True)
        jp = japi.build_model(jcfg).init(jax.random.PRNGKey(seed))
        lm = self.empty_params()
        lm.load_state_dict(params_from_jax(_np(jp)))
        return lm

    monkeypatch.setattr(tapi.LMModel, "init", init)
    jm = JaxMeta({"ModelGen.train_epochs": 2})
    JaxModelGen(model="qwen2-7b", smoke=True).run(jm, [])
    tm = MetaModel({"ModelGen.train_epochs": 2})
    ModelGen(model="qwen2-7b", smoke=True, device="cpu").run(tm, [])
    ja, ta = jm.latest("dnn"), tm.latest("dnn")
    jmet, tmet = dict(ja.metrics), dict(ta.metrics)
    assert abs(tmet.pop("accuracy") - jmet.pop("accuracy")) <= 2 / 1024
    assert tmet == jmet
    _lm_close(ja.payload.params, ta.payload.params, 1e-3, 2)
