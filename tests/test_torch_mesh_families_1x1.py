"""The SSM (xLSTM), hybrid (zamba2) and enc-dec (whisper) families on a
one-rank gloo mesh (1 x 1), on the CPU at smoke size with fp32
activations: against the JAX package's unsharded functions from the
same converted parameters — the loss, every gradient, a prefill and two
decode steps — and gradient compression bit-equal to the unsharded
port's.  The multi-rank cases are ``test_torch_mesh_families.py``.

Tolerances against the reference: the loss within 1e-5; gradients, and
the prefill's and decode steps' logits, within 1e-5 of the largest (the
port on 1 x 1 is bit-equal to the unsharded port, whose gaps to the
reference are ``tests/test_torch_ssm.py``'s and
``tests/test_torch_encdec.py``'s: fp32 sums in other orders).
"""

import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models.api import build_model as jax_build
from repro.quant.policy import PrecisionPolicy as JaxPolicy
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api as tapi
from repro_torch.optim.optimizers import adamw, tree_leaves, tree_unflatten
from repro_torch.parallel.sharding import (ShardingRules, batch_placements,
                                           distribute)
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.runtime import train_loop as ttl
from test_torch_mesh_families import ARCHS, LR, B, S, _batch, _err


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo default group and its 1 x 1 mesh, destroyed after
    the test."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield make_host_mesh(1, 1, "cpu")
    finally:
        dist.destroy_process_group()


def _jax_pair(arch):
    """(JAX model, JAX params, the port's config) at smoke size, fp32."""
    jcfg = jax_config(arch, smoke=True).replace(act_dtype="float32")
    jm = jax_build(jcfg, policy=JaxPolicy(default="fp32"))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return jm, jp, get_config(arch, smoke=True).replace(act_dtype="float32")


def _sharded(model, mesh, state_dict):
    rules = ShardingRules.default(mesh)
    lm = model.empty_params()
    lm.load_state_dict(state_dict)
    return ttl.shard_params(lm, ttl.state_shardings(model, rules, "sgd")[
        "params"])


def _stacked(tree):
    """A per-block tree of full tensors in the JAX layout: lists
    stacked."""
    if isinstance(tree, dict):
        return {k: _stacked(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return torch.stack(tree)
    return tree


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_equals_jax(one_rank, arch):
    """1 x 1: the loss and its gradient with respect to every parameter,
    a prefill and two decode steps (the cache placed by the rules)
    against the reference's unsharded functions."""
    mesh = one_rank
    jm, jp, cfg = _jax_pair(arch)
    model = tapi.build_model(cfg, PrecisionPolicy(default="fp32"), "cpu",
                             mesh=mesh)
    params = _sharded(model, mesh, params_from_jax(jp))
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v.numpy().astype(
        np.float32 if v.is_floating_point() else np.int32))
        for k, v in batch.items()}
    put = {k: distribute(v, mesh, batch_placements(mesh))
           for k, v in batch.items()}
    # the loss and the gradients
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jbatch), has_aux=True)(
        jax.tree.map(jnp.asarray, jp))
    tree = params.param_tree(per_block=True)
    leaves = tree_leaves(tree)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _ = model.loss(params, put)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    assert abs(float(loss.detach().full_tensor()) - float(jloss)) <= 1e-5
    full = [g.full_tensor() for g in grads]
    got = _leaves(_stacked(tree_unflatten(tree, full)))
    want = _leaves(jax.tree.map(np.asarray, jgrads))
    assert sorted(got) == sorted(want)
    for k in want:
        w = torch.from_numpy(np.array(want[k], np.float32))
        assert _err(got[k], w) <= 1e-5 * max(float(w.abs().max()), 1e-30), k
    # a prefill and two decode steps
    rules = ShardingRules.default(mesh)
    jcache, _ = jm.init_cache(B, S + 4, jnp.float32)
    cache = ttl.place_cache(model.init_cache(B, S + 4, torch.float32),
                            ttl.cache_shardings(model, rules, B, S + 4))
    pb = {k: v for k, v in put.items() if k != "labels"}
    jl, jcache = jm.prefill(jax.tree.map(jnp.asarray, jp),
                            {k: v for k, v in jbatch.items()
                             if k != "labels"}, jcache)
    lg, cache = model.prefill(params, pb, cache)
    steps = [(lg, jl)]
    tok = batch["tokens"][:, :1]
    for _ in range(2):
        jl, jcache = jm.decode_step(jax.tree.map(jnp.asarray, jp), jcache,
                                    jnp.asarray(tok.numpy().astype(np.int32)))
        lg, cache = model.decode_step(params, cache,
                                      distribute(tok, mesh,
                                                 batch_placements(mesh)))
        steps.append((lg, jl))
        tok = torch.from_numpy(np.array(jnp.argmax(jl[:, -1:], -1)))
    for i, (lg, jl) in enumerate(steps):
        w = torch.from_numpy(np.asarray(jl, np.float32))
        assert _err(lg.full_tensor(), w) <= 1e-5 * float(w.abs().max()), i


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_grad_compression_bit_equal(one_rank, arch):
    """1 x 1: two AdamW steps with gradient compression — the residuals
    placed like the parameters — bit for bit the unsharded trainer's:
    losses, parameters and residuals."""
    mesh = one_rank
    cfg = get_config(arch, smoke=True).replace(act_dtype="float32")
    pol = PrecisionPolicy(default="fp32")
    plain = tapi.build_model(cfg, pol, "cpu")
    model = tapi.build_model(cfg, pol, "cpu", mesh=mesh)
    st0 = ttl.init_train_state(plain, adamw(LR), 0, grad_compression=True)
    st1 = ttl.shard_state(
        ttl.init_train_state(model, adamw(LR), 0, grad_compression=True),
        ttl.state_shardings(model, ShardingRules.default(mesh), "adamw"))
    step0 = ttl.make_train_step(plain, adamw(LR), grad_compression=True)
    step1 = ttl.make_train_step(model, adamw(LR), grad_compression=True)
    batch = _batch(cfg)
    put = {k: distribute(v, mesh, batch_placements(mesh))
           for k, v in batch.items()}
    for _ in range(2):
        st0, m0 = step0(st0, batch)
        st1, m1 = step1(st1, put)
        assert float(m0["loss"]) == float(m1["loss"])
    for a, b in zip(st0["params"].parameters(), st1["params"].parameters()):
        assert torch.equal(a, b.full_tensor())
    res0, res1 = (tree_leaves(s["residuals"]) for s in (st0, st1))
    assert any(float(r.abs().max()) > 0 for r in res0)
    pl = [p.placements for p in tree_leaves(
        st1["params"].param_tree(per_block=True))]
    for a, b, want in zip(res0, res1, pl):
        assert b.placements == want and torch.equal(a, b.full_tensor())
