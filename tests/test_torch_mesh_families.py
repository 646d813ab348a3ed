"""The SSM (xLSTM), hybrid (zamba2) and enc-dec (whisper) families, the
MoE FFN off expert parallelism, and gradient compression on a device
mesh, on the CPU at smoke size with fp32 activations (unless a case says
otherwise); the one-rank mesh against the JAX package is
``test_torch_mesh_families_1x1.py``.

- Four gloo ranks (one process each, a ``FileStore`` under ``tmp_path``,
  a 60 s collective timeout) on a 2 x 2 mesh against the unsharded
  port: two AdamW steps with clipping, with and without gradient
  compression (its residuals at the parameters' placements, each
  leaf's compression against the unsharded arithmetic on the same
  gradients); a prefill and three decode steps with the cache placed by
  the rules (the recurrent states over ``model``, zamba2's and
  whisper's self-attention caches with their sequence over ``model``);
  whisper's cross-attention with its heads split; one bf16 case a
  family; ``launch/train.py --mesh 2x2 --grad-compression`` through an
  injected node failure; and ``moe_ffn`` on a 1 x 4 mesh whose
  ``model`` axis does not divide 6 experts.
- ``lower_cell`` on the placeholder 16 x 16 world (a subprocess): the
  three families at decode_32k at full width, and a train cell with
  gradient compression.

Tolerances:
- 2 x 2 against the unsharded port: losses within 1e-6 relatively,
  parameters within 1e-6 as ``|Δθ|₂ / |θ|₂`` (``test_torch_sharding.py``'s
  measure), logits within 1e-6 of the largest.  With gradient
  compression the parameters are held at 1e-4: the batch shards' partial
  gradients are added in another order, and a gradient whose scaled
  value sits within an ulp of a rounding midpoint takes the neighbouring
  int8 level, one quantization step apart; where that level is 0 on one
  side, AdamW moves the element by up to ``lr`` on the other
  (readings: 1.3e-5 zamba2, 3.6e-6 whisper, 8.0e-7 xlstm).  The
  compression itself is held bit for bit: each leaf on the mesh against
  the unsharded arithmetic on the same (gathered) gradients and
  residuals;
- bf16 activations: greedy tokens equal on the rows whose top-2 gap is
  at least 0.05, as ``test_torch_ssm.py`` and ``test_torch_encdec.py``
  hold bf16 runs (the logits read up to one bf16 ulp of the largest
  apart: bf16 sums in other orders);
- the MoE FFN: bit-equal to the unsharded ``_moe_routed``, and within
  1e-5 of the reference's ``_moe_dense_reference``
  (``test_torch_moe.py``'s tolerance).
"""

import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import layers as JL
from repro_torch.configs.registry import get_config
from repro_torch.models import api as tapi
from repro_torch.models import layers as L
from repro_torch.optim import compression as C
from repro_torch.optim.optimizers import adamw
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.runtime import train_loop as ttl

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("xlstm_125m", "zamba2_2p7b", "whisper_small")
LR = 1e-3
B, S = 4, 16              # the batch and the prompt (prefill) length
COMPRESSED_TOL = 1e-4
BF16_GAP = 0.05


def _batch(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    if cfg.enc_dec:
        batch["frames"] = 0.1 * torch.randn((B, cfg.n_frames, cfg.d_model),
                                            generator=gen)
    return batch


def _rel(a, b) -> float:
    num = sum(float(((x.double() - y.double()) ** 2).sum())
              for x, y in zip(a, b))
    den = sum(float((x.double() ** 2).sum()) for x in a)
    return (num / den) ** 0.5


def _err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


# ------------------------------------------------------------ four ranks
WORKER = textwrap.dedent("""
    import contextlib, datetime, io, json, os, sys
    import torch, torch.distributed as dist
    rank, world, store, d = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train as tlaunch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api as tapi, layers as L
    from repro_torch.models import transformer as T
    from repro_torch.optim import compression as C
    from repro_torch.optim.optimizers import adamw
    from repro_torch.parallel.sharding import (ShardingRules,
                                               batch_placements, distribute)
    from repro_torch.quant.policy import PrecisionPolicy
    from repro_torch.runtime import train_loop as ttl
    ins = torch.load(os.path.join(d, "in.pt"))
    out = {}

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    mesh = make_host_mesh(2, 2, "cpu")
    rules = ShardingRules.default(mesh)
    bp = batch_placements(mesh)
    fp32 = PrecisionPolicy(default="fp32")
    # record each leaf group's compression: inputs and outputs, whole
    comp = []
    orig = C.compress_stack_with_feedback

    def recorded(grads, residuals):
        gs, rs = orig(grads, residuals)
        comp.append({"grads": [full(g) for g in grads],
                     "res_in": [full(r) for r in residuals],
                     "out": [full(g) for g in gs], "res": [full(r) for r in rs],
                     "placements": [str(r.placements) for r in rs],
                     "want": [str(g.placements) for g in grads]})
        return gs, rs
    C.compress_stack_with_feedback = recorded
    for arch in %(archs)r:
        cfg = get_config(arch, smoke=True).replace(act_dtype="float32")
        batch = {k: distribute(v, mesh, bp) for k, v in ins[arch].items()}
        model = tapi.build_model(cfg, fp32, "cpu", mesh=mesh)
        for compress in (False, True):
            comp.clear()
            state = ttl.shard_state(
                ttl.init_train_state(model, adamw(%(lr)r), 0,
                                     grad_compression=compress),
                ttl.state_shardings(model, rules, "adamw"))
            step = ttl.make_train_step(model, adamw(%(lr)r),
                                       grad_compression=compress)
            losses = []
            for i in range(2):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            out[(arch, "train", compress)] = {
                "losses": losses,
                "params": [full(p).detach() for p in
                           state["params"].parameters()],
                "compressed": list(comp)}
        # a prefill and three decode steps, the cache placed by the rules
        for adt in ("float32", "bfloat16"):
            dcfg = cfg.replace(act_dtype=adt)
            pol = fp32 if adt == "float32" else None
            dm = tapi.build_model(dcfg, pol, "cpu", mesh=mesh)
            params = ttl.shard_params(dm.init(0), ttl.state_shardings(
                dm, rules, "sgd")["params"])
            cache = ttl.place_cache(
                dm.init_cache(4, 24, dcfg.adt),
                ttl.cache_shardings(dm, rules, 4, 24))
            pb = {k: v for k, v in batch.items() if k != "labels"}
            if "frames" in pb:
                pb["frames"] = pb["frames"].to(dcfg.adt)
            lg, cache = dm.prefill(params, pb, cache)
            logits = [full(lg)]
            for tok in ins["next"]:
                lg, cache = dm.decode_step(params, cache,
                                           distribute(tok, mesh, bp))
                logits.append(full(lg))
            out[(arch, "decode", adt)] = {
                "logits": logits,
                "state": str(cache["blocks"]["mlstm"]["C"].placements
                             if arch == "xlstm_125m" else
                             cache["mamba"]["ssd"].placements
                             if arch == "zamba2_2p7b" else
                             cache["self"]["k"].placements)}
    C.compress_stack_with_feedback = orig
    # whisper's cross-attention, heads split over model
    cfg = get_config("whisper_small", smoke=True).replace(act_dtype="float32")
    ecfg = T._enc_cfg(cfg)
    cm = tapi.build_model(cfg, fp32, "cpu", mesh=mesh)
    cp = ttl.shard_params(cm.init(0), ttl.state_shardings(
        cm, rules, "sgd")["params"])
    x = ins["cross"]
    from torch.distributed.tensor import Shard
    kvpl = tuple(Shard(0) if a == "data" else Shard(2)
                 for a in mesh.mesh_dim_names)
    k, v = (distribute(t, mesh, kvpl) for t in ins["cross_kv"])
    y, _ = L.attention(cm.ctx(), ecfg, cp.dec_blocks[0].cross,
                       distribute(x, mesh, bp), torch.arange(x.shape[1]),
                       kv_override=(k, v, torch.arange(cfg.n_frames)))
    out["cross"] = full(y)
    # moe_ffn on 1 x 4: 6 experts do not divide over model
    gcfg = get_config("granite_moe_1b_a400m", smoke=True).replace(
        act_dtype="float32", n_experts=6)
    m4 = make_host_mesh(1, 4, "cpu")
    gm = tapi.build_model(gcfg, fp32, "cpu", mesh=m4)
    gp = ttl.shard_params(gm.init(0), ttl.state_shardings(
        gm, ShardingRules.default(m4), "sgd")["params"])
    out["moe"] = full(L.moe_ffn(gm.ctx(), gcfg, gp.blocks[0].moe,
                                distribute(ins["moe_x"], m4,
                                           batch_placements(m4))))
    # launch/train.py --mesh 2x2 --grad-compression, a node lost at step 3
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tlaunch.main(["--arch", "zamba2_2p7b", "--smoke", "--device", "cpu",
                      "--mesh", "2x2", "--grad-compression", "--steps", "4",
                      "--ckpt-every", "2", "--inject-failures", "3",
                      "--batch", "4", "--seq-len", "16",
                      "--ckpt-dir", os.path.join(d, "launch")])
    if rank == 0:
        text = buf.getvalue()
        out["launch"] = json.loads(text[text.index("{"):])
        torch.save(out, os.path.join(d, "out.pt"))
    dist.destroy_process_group()
""") % {"lr": LR, "archs": ARCHS}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_families")
    gen = torch.Generator().manual_seed(11)
    ins = {arch: _batch(get_config(arch, smoke=True)) for arch in ARCHS}
    ins["next"] = [torch.randint(0, 256, (B, 1), generator=gen)
                   for _ in range(3)]
    wcfg = get_config("whisper_small", smoke=True)
    ins["cross"] = torch.randn((B, 5, wcfg.d_model), generator=gen)
    ins["cross_kv"] = [torch.randn((B, wcfg.n_frames, wcfg.n_kv_heads,
                                    wcfg.hd), generator=gen)
                       for _ in range(2)]
    gcfg = get_config("granite_moe_1b_a400m", smoke=True)
    ins["moe_x"] = torch.randn((B, 8, gcfg.d_model), generator=gen)
    torch.save(ins, d / "in.pt")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "4", str(d / "store"),
         str(d)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    logs = [p.communicate(timeout=600) for p in procs]
    assert all(p.returncode == 0 for p in procs), logs[0][1][-3000:]
    return {"out": torch.load(d / "out.pt"), "in": ins}


def _unsharded_train(arch, batch, compress):
    cfg = get_config(arch, smoke=True).replace(act_dtype="float32")
    model = tapi.build_model(cfg, PrecisionPolicy(default="fp32"), "cpu")
    state = ttl.init_train_state(model, adamw(LR), 0,
                                 grad_compression=compress)
    step = ttl.make_train_step(model, adamw(LR), grad_compression=compress)
    losses = []
    for _ in range(2):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses, [p.detach() for p in state["params"].parameters()]


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_2x2_equals_unsharded(ranks, arch, compress):
    """Two AdamW steps with clipping on 2 x 2 against the unsharded port;
    with compression, every leaf's compression on the mesh is the
    unsharded arithmetic on the same gradients and residuals, bit for
    bit, and the residuals sit at the gradients' (the parameters')
    placements."""
    got = ranks["out"][(arch, "train", compress)]
    losses, params = _unsharded_train(arch, ranks["in"][arch], compress)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-6)
    rel = _rel(params, got["params"])
    print(f"{arch} compress={compress}: |dθ|/|θ| {rel:.3e}")
    assert rel <= (COMPRESSED_TOL if compress else 1e-6)
    assert bool(got["compressed"]) == compress
    for rec in got["compressed"]:
        gs, rs = C.compress_stack_with_feedback(rec["grads"], rec["res_in"])
        assert all(torch.equal(a, b) for a, b in zip(gs, rec["out"]))
        assert all(torch.equal(a, b) for a, b in zip(rs, rec["res"]))
        assert rec["placements"] == rec["want"]


def _unsharded_decode(arch, ins, adt):
    cfg = get_config(arch, smoke=True).replace(act_dtype=adt)
    pol = PrecisionPolicy(default="fp32") if adt == "float32" else None
    model = tapi.build_model(cfg, pol, "cpu")
    params = model.init(0)
    cache = model.init_cache(B, 24, cfg.adt)
    pb = {k: v for k, v in ins[arch].items() if k != "labels"}
    if "frames" in pb:
        pb["frames"] = pb["frames"].to(cfg.adt)
    lg, cache = model.prefill(params, pb, cache)
    logits = [lg]
    for tok in ins["next"]:
        lg, cache = model.decode_step(params, cache, tok)
        logits.append(lg)
    return logits


@pytest.mark.parametrize("adt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_three_decode_steps_2x2(ranks, arch, adt):
    """A prefill and three decode steps on 2 x 2, the cache placed by the
    rules — the recurrent states over ``model``, the self-attention
    caches' sequence over ``model`` — against the unsharded port, fed
    the same tokens: each step's logits in fp32 (so each state and cache
    was advanced in place); under bf16 activations each step's greedy
    token on every row the unsharded logits decide (a top-2 gap of at
    least :data:`BF16_GAP`), as ``test_torch_ssm.py`` and
    ``test_torch_encdec.py`` hold bf16 runs, the logits' gap printed."""
    got = ranks["out"][(arch, "decode", adt)]
    want = _unsharded_decode(arch, ranks["in"], adt)
    decided = 0
    for i, (a, b) in enumerate(zip(got["logits"], want, strict=True)):
        scale = float(b.float().abs().max())
        if adt == "float32":
            assert _err(a, b) <= 1e-6 * scale, i
            continue
        print(f"{arch} bf16 step {i}: |d logits| {_err(a, b) / scale:.3e} "
              f"of the largest")
        top = b[:, -1].float().topk(2, dim=-1).values
        rows = (top[:, 0] - top[:, 1]) >= BF16_GAP
        decided += int(rows.sum())
        assert torch.equal(a[:, -1].argmax(-1)[rows],
                           b[:, -1].argmax(-1)[rows]), i
    assert adt == "float32" or decided > 0
    # (L, B, ...) stacks: the batch over data, the state's heads or the
    # cache's sequence over model
    assert got["state"] == "(Shard(dim=1), Shard(dim=2))"


def test_cross_attention_2x2_heads_split(ranks):
    """whisper-smoke's cross-attention (``kv_override``) on 2 x 2 with the
    K/V's heads over ``model``: the unsharded cross-attention within 1e-6
    of the largest output."""
    cfg = get_config("whisper_small", smoke=True).replace(act_dtype="float32")
    model = tapi.build_model(cfg, PrecisionPolicy(default="fp32"), "cpu")
    p = model.init(0).dec_blocks[0].cross
    x = ranks["in"]["cross"]
    k, v = ranks["in"]["cross_kv"]
    from repro_torch.models import transformer as T
    want, _ = L.attention(model.ctx(), T._enc_cfg(cfg), p, x,
                          torch.arange(x.shape[1]),
                          kv_override=(k, v, torch.arange(cfg.n_frames)))
    got = ranks["out"]["cross"]
    assert _err(got, want) <= 1e-6 * float(want.abs().max())


def test_moe_ffn_off_expert_parallelism(ranks):
    """granite-smoke with 6 experts on a 1 x 4 mesh (``model`` does not
    divide them): ``moe_ffn`` runs the routed function on each rank's
    rows, bit-equal to the unsharded ``_moe_routed``, and within 1e-5 of
    the reference's ``_moe_dense_reference`` (the reference's choice on
    such a mesh)."""
    cfg = get_config("granite_moe_1b_a400m", smoke=True).replace(
        act_dtype="float32", n_experts=6)
    moe = tapi.build_model(cfg, PrecisionPolicy(default="fp32"),
                           "cpu").init(0).blocks[0].moe
    x = ranks["in"]["moe_x"]
    got = ranks["out"]["moe"]
    assert torch.equal(got, L._moe_routed(cfg, moe, x, None))
    jcfg = jax_config("granite_moe_1b_a400m", smoke=True).replace(
        act_dtype="float32", n_experts=6)
    jp = {n: jnp.asarray(getattr(moe, n).numpy())
          for n in ("router", "w_gate", "w_up", "w_down")}
    want = np.asarray(JL._moe_dense_reference(None, jcfg, jp,
                                              jnp.asarray(x.numpy())))
    assert float(np.abs(got.numpy() - want).max()) <= \
        1e-5 * float(np.abs(want).max())


def test_launch_train_mesh_grad_compression_restart(ranks):
    """``launch/train.py --mesh 2x2 --grad-compression`` on zamba2-smoke,
    a node lost at step 3: one restart from step 1's checkpoint (the
    residuals restored onto the mesh), step 2 replayed, a finite loss."""
    rep = ranks["out"]["launch"]
    assert rep["mesh"] == [2, 2] and rep["devices"] == 4
    assert rep["restarts"] == 1 and rep["steps_run"] == 4 + 1
    assert np.isfinite(rep["final_loss"])


# ------------------------------------------------- the dry run (16 x 16)
DRY = textwrap.dedent("""
    import json
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.optim.optimizers import tree_leaves
    out = {}
    for arch in ("xlstm-125m", "zamba2-2.7b", "whisper-small"):
        lowered, mesh, model, aux = lower_cell(arch, SHAPES["decode_32k"])
        c = lowered.compile()
        out[arch] = {"flops": c.flops, "coll": c.collectives.total_bytes,
                     "counts": c.collectives.counts,
                     "arg": c.memory.argument_size_in_bytes,
                     "chips": mesh.size()}
    # a train cell with gradient compression: the residuals among the
    # arguments, placed like the parameters (zamba2 cut to one segment)
    for comp in (False, True):
        lowered, mesh, model, aux = lower_cell(
            "zamba2-2.7b", SHAPES["train_4k"], grad_compression=comp,
            cfg_overrides={"n_layers": 6})
        n = len(list(model.abstract_params().parameters()))
        c = lowered.compile()
        out[f"train_{comp}"] = {
            "arg": c.memory.argument_size_in_bytes, "bytes": c.bytes,
            "f32_params": 4 * sum(a.to_local().numel()
                                  for a in lowered.args[:n])}
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def dry():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", DRY], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [t for t in r.stdout.splitlines() if t.startswith("RESULT ")][0]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-2.7b",
                                  "whisper-small"])
def test_dry_run_decode_32k_on_16x16(dry, arch):
    """Rank 0 of the placeholder 16 x 16 world at decode_32k, full width:
    the step runs on the meta shards, with FLOPs, arguments and the
    mixers' or the attention's collectives counted."""
    c = dry[arch]
    assert c["chips"] == 256 and c["flops"] > 0 and c["arg"] > 0
    assert c["coll"] > 0 and sum(c["counts"].values()) > 0


def test_dry_run_train_with_grad_compression(dry):
    """``lower_cell(grad_compression=True)`` on zamba2 cut to one segment
    at train_4k: the fp32 residuals join the arguments, one rank's shard
    of each parameter's (placed like the parameters), and the step reads
    and writes more bytes (the compression's passes)."""
    off, on = dry["train_False"], dry["train_True"]
    assert on["arg"] - off["arg"] == on["f32_params"] > 0
    assert on["bytes"] > off["bytes"]
