"""The port's distribution stack against the JAX package.

- Spec parity: the logical-axis rules' decisions for every registry
  config at full width on stand-in 16 x 16 and 2 x 16 x 16 meshes (shape
  only: neither package needs the devices), parameters (FSDP on and off,
  computed on the reference's stacked shapes and mapped onto the port's
  per-block tensors), the decode cache at decode_32k, the optimizer
  state's axes, the input stand-ins and the fallbacks recorded.
- Four gloo ranks (one process each, a ``FileStore`` under ``tmp_path``,
  a 60 s collective timeout): the sharded trainer against the unsharded
  port (1e-6) and the reference's sharded step on a 1 x 1 mesh (1e-5),
  with FSDP off, on and ZeRO-1; the int8-mlp MLP bit for bit; decode
  with the cache's sequence over ``model`` and on a 4 x 1 mesh;
  ``ShardedBatcher(rules=...)`` rows; the elastic restore onto 4 x 1 and
  1 x 4 bit for bit; ``launch/train.py --mesh 2x2`` against ``--mesh
  1x1``.

The multi-rank tolerances are relative to a whole: ``|Δθ|₂ / |θ|₂`` over
every parameter after two AdamW steps (an element whose gradient is
near 0 moves by up to ``lr`` on a sign, in any pair of fp32 runs that
sum in different orders), and the loss's relative error.
"""

import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.registry import ARCH_IDS, get_config as jax_config
from repro.models import api as japi
from repro.optim import optimizers as jopt
from repro.parallel.sharding import ShardingRules as JRules
from repro.quant.policy import PrecisionPolicy as JaxPolicy
from repro.runtime import train_loop as jtl
from repro_torch.checkpoint.manager import CheckpointManager, _flatten
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.convert import _tensor, state_from_jax, state_to_jax
from repro_torch.data.pipeline import TokenSource
from repro_torch.models import api as tapi
from repro_torch.models import layers as L
from repro_torch.optim import optimizers as topt
from repro_torch.parallel import sharding as S
from repro_torch.quant.policy import INT8, PrecisionPolicy
from repro_torch.runtime import train_loop as ttl

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LR = 1e-3
STEPS = 2
# the smoke configs widened so that FSDP's 2**20-element threshold bites
# (the embedding and the lm_head)
VOCAB = {"qwen2_7b": 20000, "starcoder2_3b": 16640}
MODES = ("none", "fsdp", "zero1")
PROD = {"16x16": ((16, 16), ("data", "model")),
        "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


# ------------------------------------------------------------ spec parity
def _jax_mesh(shape, names):
    """The reference's rules read only these two attributes."""
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


def _tup(spec):
    return tuple(tuple(e) if isinstance(e, tuple) else e for e in spec)


def _specs_np(tree):
    return jax.tree.map(_tup, tree,
                        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


@pytest.mark.parametrize("mesh", sorted(PROD))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_parity_full_width(arch, mesh):
    shape, names = PROD[mesh]
    jm = japi.build_model(jax_config(arch))
    tm = tapi.build_model(get_config(arch), device="cpu")
    jshapes, jaxes = jm._abstract
    # the axes trees and the stacked shapes are the reference's
    assert tm.param_axes() == jax.tree.map(
        tuple, jaxes, is_leaf=lambda x: isinstance(x, tuple))
    tshapes = S.tree_map(lambda t: tuple(t.shape),
                         tm.abstract_params().param_tree(),
                         is_leaf=lambda t: not isinstance(t, dict))
    assert tshapes == jax.tree.map(lambda s: tuple(s.shape), jshapes)
    for fsdp in (False, True):
        jr = JRules.default(_jax_mesh(shape, names))
        tr = S.ShardingRules.default(S.MeshShape(names, shape))
        jspec = _specs_np(jr.param_specs(jaxes, jshapes, fsdp=fsdp))
        tspec = tr.param_specs(tm.param_axes(), tshapes, fsdp=fsdp)
        assert tspec == jspec
        assert jr.fallbacks == tr.fallbacks
        # every stacked spec maps onto one block's tensor
        S.tree_map(lambda sp, ax: S.block_spec(sp) if ax[0] == "layers"
                   else sp, tspec, tm.param_axes())
    # the optimizer state's axes
    assert topt.opt_state_axes("adamw", tm.param_axes()) == jax.tree.map(
        tuple, jopt.opt_state_axes("adamw", jaxes),
        is_leaf=lambda x: isinstance(x, tuple))
    # inputs: shapes and dtypes of every shape's stand-ins
    for name, sh in SHAPES.items():
        ji, ti = jm.input_specs(JSHAPES[name]), tm.input_specs(sh)
        assert sorted(ji) == sorted(ti)
        for k in ji:
            assert tuple(ti[k].shape) == ji[k].shape
            assert str(ti[k].dtype).split(".")[1] == str(ji[k].dtype)
    # the decode cache at decode_32k: shapes, axes, specs, fallbacks
    dec = SHAPES["decode_32k"]
    jc, jca = jm.abstract_cache(dec.global_batch, dec.seq_len)
    tc, tca = tm.abstract_cache(dec.global_batch, dec.seq_len)
    tcs = S.tree_map(lambda t: tuple(getattr(t, "shape", ())), tc,
                     is_leaf=lambda t: not isinstance(t, dict))
    assert tcs == jax.tree.map(lambda s: tuple(s.shape), jc)
    assert tca == jax.tree.map(tuple, jca,
                               is_leaf=lambda x: isinstance(x, tuple))
    jr = JRules.default(_jax_mesh(shape, names))
    tr = S.ShardingRules.default(S.MeshShape(names, shape))
    assert tr.tree_specs(tca, tcs) == _specs_np(jr.tree_specs(jca, jc))
    assert jr.fallbacks == tr.fallbacks


@pytest.mark.parametrize("override", [None, "data"])
def test_fallbacks_qwen2_on_16x16(override):
    """Qwen2-7B's 4 KV heads on a 16-wide model axis: the cache records
    the reference's fallback when its sequence does not take ``model``
    (and none when it does), string for string."""
    shape, names = PROD["16x16"]
    dec = SHAPES["decode_32k"]
    ov = {"cache_seq": override} if override else None
    jr = JRules.default(_jax_mesh(shape, names), overrides=ov)
    tr = S.ShardingRules.default(S.MeshShape(names, shape), overrides=ov)
    jm = japi.build_model(jax_config("qwen2_7b"))
    tm = tapi.build_model(get_config("qwen2_7b"), device="cpu")
    jc, jca = jm.abstract_cache(dec.global_batch, dec.seq_len)
    tc, tca = tm.abstract_cache(dec.global_batch, dec.seq_len)
    jr.tree_specs(jca, jc)
    tr.tree_specs(tca, S.tree_map(lambda t: tuple(getattr(t, "shape", ())),
                                  tc, is_leaf=lambda t: not isinstance(t, dict)))
    assert tr.fallbacks == jr.fallbacks
    assert bool(tr.fallbacks) == (override == "data")


def test_rules_unit_cases():
    """The reference's own rule cases (tests/test_sharding.py) and the
    placements they give on a mesh's names."""
    m = S.MeshShape(("data", "model"), (1, 1))
    assert S.ShardingRules.default(m).spec_for(("vocab", "embed"),
                                               (1024, 64)) == ("model",)
    spec = S.ShardingRules.default(m).spec_for(("cache_seq", "kv_heads"),
                                               (64, 8))
    assert len([e for e in spec if e]) == len(set(e for e in spec if e))
    assert S.ShardingRules.default(m, overrides={"cache_seq": None}
                                   ).spec_for(("cache_seq",), (64,)) == ()
    wide = S.MeshShape(("pod", "data", "model"), (2, 16, 16))
    r = S.ShardingRules.default(wide)
    assert r.spec_for(("batch", None), (128, 1)) == (("pod", "data"),)
    assert r.spec_for(("heads",), (28,)) == ()
    assert r.fallbacks == ["heads:dim28%16!=0->replicated"]
    from torch.distributed.tensor import Replicate, Shard
    assert S.placements_for((("pod", "data"), "model"), wide) == (
        Shard(0), Shard(0), Shard(1))
    assert S.placements_for((None, "model"), wide) == (
        Replicate(), Replicate(), Shard(1))
    with pytest.raises(ValueError):
        S.placements_for((("data", "pod"),), wide)
    with pytest.raises(ValueError):
        S.block_spec(("data", None))


# ------------------------------------------------------------ four ranks
WORKER = textwrap.dedent("""
    import contextlib, datetime, io, json, os, sys
    import torch, torch.distributed as dist
    rank, world, store, arch, d = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4], sys.argv[5])
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    from repro_torch.checkpoint.manager import CheckpointManager, _flatten
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import state_from_jax, state_to_jax
    from repro_torch.data.pipeline import ShardedBatcher, TokenSource
    from repro_torch.launch import train as tlaunch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api as tapi, layers as L
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import adamw
    from repro_torch.parallel.sharding import (ShardingRules,
                                               batch_placements, distribute)
    from repro_torch.quant.policy import INT8, PrecisionPolicy
    from repro_torch.runtime import train_loop as ttl
    spec = json.load(open(os.path.join(d, "spec.json")))
    cfg = get_config(arch, smoke=True).replace(
        act_dtype="float32", vocab_size=spec["vocab"])
    pol = PrecisionPolicy(default="fp32")
    out = {}
    mesh = make_host_mesh(2, 2, "cpu")
    src = TokenSource(cfg.vocab_size, 4, 16)
    for mode in spec["modes"]:
        model = tapi.build_model(cfg, pol, "cpu", mesh=mesh)
        rules = ShardingRules.default(mesh)
        sh = ttl.state_shardings(model, rules, "adamw",
                                 fsdp=mode == "fsdp", zero1=mode == "zero1")
        tree, _ = CheckpointManager(os.path.join(d, "init")).restore(
            shardings=sh)
        state = state_from_jax(tree, model, sh)
        batcher = ShardedBatcher(src, rules, prefetch=False, device="cpu")
        step = ttl.make_train_step(model, adamw(%(lr)r))
        losses = []
        for i in range(%(steps)d):
            state, m = step(state, batcher.get(i))
            losses.append(float(m["loss"]))
        placed = {str(p.placements) for p in state["params"].parameters()}
        placed_m = {str(t.placements) for t in
                    ttl.tree_leaves(state["opt"]["m"])}
        ck = CheckpointManager(os.path.join(d, mode), async_save=False)
        ck.save(%(steps)d - 1, state_to_jax(state))
        out[mode] = {"losses": losses, "placements": sorted(placed),
                     "moments": sorted(placed_m)}
    # the batch rows each rank holds
    b = batcher.get(5)["tokens"]
    full = torch.from_numpy(src.batch_at(5)["tokens"]).long()
    rows = b.to_local()
    r0 = mesh.get_coordinate()[0] * rows.shape[0]
    out["rows_ok"] = bool(torch.equal(rows, full[r0:r0 + rows.shape[0]]))
    # the int8-mlp MLP of block 0 on 2 x 2
    ipol = PrecisionPolicy(default="fp32").with_rule("*mlp*", INT8)
    im = tapi.build_model(cfg, ipol, "cpu", mesh=mesh)
    ip = ttl.shard_params(im.init(0), ttl.state_shardings(
        im, ShardingRules.default(mesh), "sgd")["params"])
    x = torch.load(os.path.join(d, "x.pt"))
    y = L.mlp(im.ctx(), cfg, ip.blocks[0].mlp,
              distribute(x, mesh, batch_placements(mesh))).full_tensor()
    # decode: the cache's sequence over model on 2 x 2, and on 4 x 1
    dec = torch.load(os.path.join(d, "dec.pt"))
    logits = {}
    for shape in ("2x2", "4x1"):
        m2 = make_host_mesh(*map(int, shape.split("x")), device="cpu")
        dm = tapi.build_model(cfg, pol, "cpu", mesh=m2)
        r2 = ShardingRules.default(m2)
        dp = ttl.shard_params(dm.init(0), ttl.state_shardings(
            dm, r2, "sgd")["params"])
        bsz, slen = dec["prompt"].shape
        c = ttl.place_cache(dm.init_cache(bsz, 2 * slen, torch.float32),
                            ttl.cache_shardings(dm, r2, bsz, 2 * slen))
        bp = batch_placements(m2)
        _, c = dm.prefill(dp, {"tokens": distribute(dec["prompt"], m2, bp)}, c)
        lg, c = dm.decode_step(dp, c, distribute(dec["next"], m2, bp))
        logits[shape] = lg.full_tensor()
        out["cache_" + shape] = str(c["k"].placements)
    if rank == 0:
        torch.save({"mlp": y, "logits": logits}, os.path.join(d, "out.pt"))
    if spec["elastic"]:
        saved, _ = CheckpointManager(os.path.join(d, "none")).restore()
        flat = _flatten(saved)
        worst = 0.0
        for shape in ("4x1", "1x4"):
            m3 = make_host_mesh(*map(int, shape.split("x")), device="cpu")
            em = tapi.build_model(cfg, pol, "cpu", mesh=m3)
            sh3 = ttl.state_shardings(em, ShardingRules.default(m3), "adamw")
            tree, _ = CheckpointManager(os.path.join(d, "none")).restore(
                shardings=sh3)
            for k, v in _flatten(tree).items():
                parts = v if isinstance(v, list) else [v]
                whole = torch.stack([p.full_tensor() for p in parts]) \\
                    if isinstance(v, list) else v.full_tensor() \\
                    if hasattr(v, "full_tensor") else v
                worst = max(worst, float((whole.float() - flat[k].float())
                                         .abs().max()))
            st = state_from_jax(tree, em, sh3)
            st, m = ttl.make_train_step(em, adamw(%(lr)r))(
                st, ShardedBatcher(src, ShardingRules.default(m3),
                                   prefetch=False, device="cpu").get(2))
            out["elastic_loss_" + shape] = float(m["loss"])
        out["elastic_max_err"] = worst
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--mesh", "2x2", "--steps", "3", "--batch", "4",
                          "--seq-len", "16",
                          "--ckpt-dir", os.path.join(d, "launch")])
        if rank == 0:
            text = buf.getvalue()
            out["launch"] = json.loads(text[text.index("{"):])
    if rank == 0:
        json.dump(out, open(os.path.join(d, "out.json"), "w"))
    dist.destroy_process_group()
""") % {"lr": LR, "steps": STEPS}


def _cfgs(arch):
    jc = jax_config(arch, smoke=True).replace(act_dtype="float32",
                                              vocab_size=VOCAB[arch])
    tc = get_config(arch, smoke=True).replace(act_dtype="float32",
                                              vocab_size=VOCAB[arch])
    return jc, tc


def _rel(a: dict, b: dict) -> float:
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in a)
    den = sum(float((a[k].double() ** 2).sum()) for k in a)
    return (num / den) ** 0.5


def _params(path: str) -> dict:
    tree, _ = CheckpointManager(path).restore()
    return {k: v.float() for k, v in _flatten(tree).items()
            if k.startswith("params/")}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """For each arch: the init (converted from the reference's), the
    unsharded port's and the reference's sharded steps, and the four
    ranks' results."""
    results = {}
    for arch in VOCAB:
        d = tmp_path_factory.mktemp(arch)
        jc, tc = _cfgs(arch)
        jm = japi.build_model(jc, policy=JaxPolicy(default="fp32"))
        tm = tapi.build_model(tc, policy=PrecisionPolicy(default="fp32"),
                              device="cpu")
        js0 = jtl.init_train_state(jm, jopt.adamw(LR), jax.random.PRNGKey(0))
        ts = state_from_jax(jax.tree.map(lambda a: _tensor(np.asarray(a)),
                                         js0), tm)
        CheckpointManager(str(d / "init"), async_save=False).save(
            -1, state_to_jax(ts))
        src = TokenSource(tc.vocab_size, 4, 16)
        step = ttl.make_train_step(tm, topt.adamw(LR))
        losses = []
        for i in range(STEPS):
            ts, m = step(ts, {k: torch.from_numpy(v).long()
                              for k, v in src.batch_at(i).items()})
            losses.append(float(m["loss"]))
        ck = CheckpointManager(str(d / "unsharded"), async_save=False)
        ck.save(STEPS - 1, state_to_jax(ts))
        # the reference's step under its state_shardings, 1 x 1 mesh
        mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    ("data", "model"))
        jref = {}
        for mode in MODES:
            rules = JRules.default(mesh)
            with mesh:
                sh = jtl.state_shardings(jm, rules, "adamw",
                                         fsdp=mode == "fsdp",
                                         zero1=mode == "zero1")
                js = jax.device_put(js0, sh)
                batch0 = {k: jnp.asarray(v) for k, v in
                          src.batch_at(0).items()}
                bsh = jtl.batch_shardings(jm, rules, batch0)
                jstep = jax.jit(jtl.make_train_step(jm, jopt.adamw(LR)),
                                in_shardings=(sh, bsh))
                for i in range(STEPS):
                    js, _ = jstep(js, {k: jnp.asarray(v) for k, v in
                                       src.batch_at(i).items()})
            jref[mode] = {f"params/{k}": torch.from_numpy(
                np.asarray(v, np.float32)) for k, v in _flatten(
                jax.tree.map(np.asarray, js["params"])).items()}
        # the unsharded MLP under int8-mlp, and decode logits
        gen = torch.Generator().manual_seed(1)
        x = torch.randn((4, 8, tc.d_model), generator=gen)
        torch.save(x, d / "x.pt")
        ipol = PrecisionPolicy(default="fp32").with_rule("*mlp*", INT8)
        im = tapi.build_model(tc, ipol, "cpu")
        y = L.mlp(im.ctx(), tc, im.init(0).blocks[0].mlp, x)
        dec = {"prompt": torch.randint(0, tc.vocab_size, (4, 8),
                                       generator=gen),
               "next": torch.randint(0, tc.vocab_size, (4, 1),
                                     generator=gen)}
        torch.save(dec, d / "dec.pt")
        dm = tapi.build_model(tc, PrecisionPolicy(default="fp32"), "cpu")
        dp = dm.init(0)
        cache = dm.init_cache(4, 16, torch.float32)
        _, cache = dm.prefill(dp, {"tokens": dec["prompt"]}, cache)
        lg, _ = dm.decode_step(dp, cache, dec["next"])
        (d / "spec.json").write_text(json.dumps(
            {"vocab": VOCAB[arch], "modes": list(MODES),
             "elastic": arch == "qwen2_7b"}))
        env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, "-c", WORKER, str(r), "4", str(d / "store"),
             arch, str(d)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(4)]
        logs = [p.communicate(timeout=600) for p in procs]
        assert all(p.returncode == 0 for p in procs), logs[0][1][-3000:]
        results[arch] = {
            "dir": d, "losses": losses, "jax": jref, "mlp": y, "logits": lg,
            "out": json.loads((d / "out.json").read_text()),
            "got": torch.load(d / "out.pt")}
    return results


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", sorted(VOCAB))
def test_sharded_train_equals_unsharded_and_jax(ranks, arch, mode):
    """Two AdamW steps with clipping on a 2 x 2 gloo mesh: the losses and
    parameters of the unsharded port within 1e-6, the reference's sharded
    step (1 x 1 mesh) within 1e-5; the parameters (and, with FSDP or
    ZeRO-1, the moments) are sharded over ``data``."""
    r = ranks[arch]
    got = r["out"][mode]
    np.testing.assert_allclose(got["losses"], r["losses"], rtol=1e-6)
    sharded = _params(str(r["dir"] / mode))
    assert _rel(_params(str(r["dir"] / "unsharded")), sharded) <= 1e-6
    assert _rel(r["jax"][mode], sharded) <= 1e-5
    # a placement string's first entry is the data axis'
    assert any(p.startswith("(Shard(") for p in got["placements"]) == (
        mode == "fsdp")
    if mode in ("fsdp", "zero1"):
        assert any(p.startswith("(Shard(") for p in got["moments"])


@pytest.mark.parametrize("arch", sorted(VOCAB))
def test_int8_mlp_bit_equal_and_batch_rows(ranks, arch):
    """The int8-mlp MLP on a 2 x 2 mesh (``int8_matmul``'s sharding rule:
    K never split) equals the unsharded one bit for bit; each rank's
    ``ShardedBatcher(rules=...)`` rows are its slice of the global
    batch."""
    r = ranks[arch]
    assert torch.equal(r["got"]["mlp"], r["mlp"])
    assert r["out"]["rows_ok"]


@pytest.mark.parametrize("shape", ["2x2", "4x1"])
@pytest.mark.parametrize("arch", sorted(VOCAB))
def test_sharded_decode_equals_unsharded(ranks, arch, shape):
    """A prefill and one decode step with the cache placed by the rules —
    on 2 x 2 its sequence over ``model`` (flash-decoding across ranks),
    on 4 x 1 whole — against the unsharded logits (fp32, 1e-5 of the
    largest)."""
    r = ranks[arch]
    lg = r["got"]["logits"][shape]
    tol = 1e-5 * float(r["logits"].abs().max())
    assert float((lg - r["logits"]).abs().max()) <= tol
    if shape == "2x2":
        assert "Shard(dim=2)" in r["out"]["cache_2x2"]  # (L, B, S…): S


def test_elastic_restore_across_mesh_shapes(ranks):
    """Trained on 2 x 2, checkpointed, restored onto 4 x 1 and 1 x 4 with
    ``shardings`` (each rank reading its shard): every leaf bit for bit,
    then one more step on each."""
    out = ranks["qwen2_7b"]["out"]
    assert out["elastic_max_err"] == 0.0
    for shape in ("4x1", "1x4"):
        assert np.isfinite(out["elastic_loss_" + shape])


def test_launch_train_mesh_2x2_equals_1x1(ranks, tmp_path, capsys):
    """``launch/train.py --mesh 2x2`` on four gloo ranks against ``--mesh
    1x1`` on one: the same losses (bf16 products summed in another order:
    2e-3)."""
    import torch.distributed as dist
    from repro_torch.launch import train as tlaunch
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        tlaunch.main(["--arch", "qwen2_7b", "--smoke", "--device", "cpu",
                      "--mesh", "1x1", "--steps", "3", "--batch", "4",
                      "--seq-len", "16", "--ckpt-dir", str(tmp_path / "c")])
    finally:
        dist.destroy_process_group()
    text = capsys.readouterr().out
    one = json.loads(text[text.index("{"):])
    four = ranks["qwen2_7b"]["out"]["launch"]
    assert one["mesh"] == [1, 1] and four["mesh"] == [2, 2]
    assert four["devices"] == 4 and four["steps_run"] == 3
    for k in ("first_loss", "final_loss"):
        np.testing.assert_allclose(four[k], one[k], rtol=2e-3)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_mesh_refusals_by_family(arch):
    """A mesh takes the dense decoders; a MoE config on a ``model`` axis
    wider than 1 names the expert-parallel slice; the other families
    refuse any mesh (a shape-only mesh: the check reads its sizes)."""
    cfg = get_config(arch)
    mesh = S.MeshShape(("data", "model"), (2, 2))
    if cfg.family in tapi.MESH_FAMILIES:
        assert tapi.build_model(cfg, device="cpu", mesh=mesh).mesh is mesh
        return
    match = "expert parallelism" if cfg.is_moe else "waits"
    with pytest.raises(NotImplementedError, match=match):
        tapi.build_model(cfg, device="cpu", mesh=mesh)
