"""The port's expert parallelism against the JAX package on the CPU.

- ``_rank_in_expert`` bit for bit against the reference's.
- The plain expert-parallel function (``layers.moe_ffn_ep_plain``, every
  rank's body in one process) against the reference's ``_moe_ep`` on
  (1, 4) and (2, 2) meshes of four forced host devices (a subprocess),
  for granite-moe-smoke (GQA) and deepseek-v2-smoke (MLA, one shared
  expert): both bodies (x (4, 16, d) takes the all-to-all body, x (2, 1,
  d) the replicated-routing one), a skewed x (4, 16, d) whose routings
  overflow the capacity, FSDP off and on, fp32 and bf16 activations, and
  the INT8 ``moe/experts`` level in decode and training.  The routings
  each rank keeps are the reference's exactly.
- Four gloo ranks (one process each, a ``FileStore`` under
  ``tmp_path``, a 60 s collective timeout): the real ``_moe_ep`` on
  those meshes against the plain function at the same (dp, tp) bit for
  bit, the layer's gradients, the MoE trainer on 2 x 2 against the
  unsharded port with plain-EP routing at (2, 2), ``"dots+moe"``
  bit-equal to ``"none"`` with one all-to-all a layer fewer in the
  recompute than ``"full"``, prefill and decode on 2 x 2 and 1 x 4 (the
  MLA cache's sequence over ``model``), ``moe_aux_loss`` on DTensors and
  ``launch/train.py --mesh 2x2`` on both MoE configs.
- The MoE trainer on a 1 x 1 mesh against the reference's sharded step
  on its 1 x 1 mesh (expert parallelism at tp = 1 in both packages).
- ``lower_cell`` for granite-moe-1b-a400m and deepseek-v2-236b at full
  width on the placeholder 16 x 16 world.

Tolerances (fp32 unless named):
- the plain function against the reference: within 1e-5 of the largest
  output (the expert products take bf16 operands with fp32 sums, in
  another order).  The reference is compiled with
  ``--xla_allow_excess_precision=false``: by default XLA's CPU compiler
  drops a bf16 rounding between fp32 values (the gate product's before
  the fp32 sum, a bf16 operand's cotangent), and the port rounds where
  the reference's code says so;
- the real function against the plain one: bit for bit; its gradients
  within 1e-6 of the largest (the partial sums over ranks are added in
  another order);
- the trainers, after two AdamW steps (on 2 x 2 against the unsharded
  port, on 1 x 1 against the reference): losses within 5e-5
  relatively, parameters within 5e-4 as ``|Δθ|₂ / |θ|₂``; on 1 x 1 bit
  for bit against the unsharded port.  The expert products round their
  operands, and the gradients of those, to bf16, so an fp32 difference
  of one ulp upstream (the attention's partial sums over ``model``,
  another summation order) moves a value by a bf16 step, which AdamW's
  normalised update carries into the parameters.  The same trainers
  with fp32 expert products in both packages (``_expert_ffn_fp32``)
  hold 1e-6 on 2 x 2 and 1e-5 on 1 x 1, losses and parameters: the
  bf16 operands are the whole of the gap.  Each trainer test prints its
  readings (``pytest -rP``);
- decode logits within 1e-5 of the largest.
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.configs.registry import get_config
from repro_torch.convert import _tensor, params_from_jax, state_from_jax
from repro_torch.data.pipeline import ShardedBatcher, TokenSource
from repro_torch.models import api as tapi
from repro_torch.models import layers as L
from repro_torch.models.common import Ctx
from repro_torch.optim import optimizers as topt
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.runtime import train_loop as ttl

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("granite_moe_1b_a400m", "deepseek_v2_236b")
MESHES = ("1x4", "2x2")
# name: (activations, fsdp_params, moe/experts level, decode)
VARIANTS = {"fp32": ("float32", False, None, False),
            "fp32_fsdp": ("float32", True, None, False),
            "bf16": ("bfloat16", False, None, False),
            "bf16_fsdp": ("bfloat16", True, None, False),
            "int8_decode": ("float32", False, "int8", True),
            "int8_train": ("float32", True, "int8", False)}
LR = 1e-3


def _inputs(cfg) -> dict:
    g = np.random.default_rng(1)
    d = cfg.d_model
    skew = (0.1 * g.standard_normal((4, 16, d))
            + 2.0 * g.standard_normal((1, 1, d)))
    return {"ep": g.standard_normal((4, 16, d)).astype(np.float32),
            "small": g.standard_normal((2, 1, d)).astype(np.float32),
            "skew": skew.astype(np.float32)}


def _policy(level):
    pol = PrecisionPolicy(default="fp32")
    return pol.with_rule("*moe/experts*", level) if level else pol


def _expert_ffn_fp32(ctx, recv, wg, wu, wd):
    """``layers._expert_ffn`` with fp32 operands (no bf16 rounding): the
    trainers' variant that shows the cause of their tolerances."""
    g = torch.bmm(recv, wg)
    return torch.bmm(torch.nn.functional.silu(g) * torch.bmm(recv, wu), wd)


# -------------------------------------------------------- _rank_in_expert
@pytest.mark.parametrize("n,e", [(1, 8), (37, 8), (256, 32), (960, 160)])
def test_rank_in_expert_bit_equal(n, e):
    ids = np.random.default_rng(n).integers(0, e, n)
    ids[: n // 3] = ids[0]              # a long run of one expert
    want = np.asarray(JL._rank_in_expert(jnp.asarray(ids, jnp.int32), e))
    got = L._rank_in_expert(torch.from_numpy(ids), e)
    assert np.array_equal(got.numpy(), want)


# ------------------------------------------- the plain function vs JAX
JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_allow_excess_precision=false")
    import pickle
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs.registry import get_config
    from repro.models import layers as L
    from repro.models.common import Ctx
    from repro.quant.policy import PrecisionPolicy
    d = sys.argv[1]
    variants = %(variants)r
    res = {}
    for arch in %(archs)r:
        cfg0 = get_config(arch, smoke=True)
        p, _ = L.init_moe(jax.random.PRNGKey(0), cfg0)
        np.savez(os.path.join(d, arch + "_moe.npz"),
                 **{k: np.asarray(v) for k, v in p.items() if k != "shared"})
        xs = dict(np.load(os.path.join(d, arch + "_x.npz")))
        for name in %(meshes)r:
            shape = tuple(map(int, name.split("x")))
            mesh = Mesh(np.array(jax.devices()).reshape(shape),
                        ("data", "model"))
            for v, (adt, fsdp, lvl, decode) in variants.items():
                cfg = cfg0.replace(act_dtype=adt)
                pol = PrecisionPolicy(default="fp32")
                if lvl:
                    pol = pol.with_rule("*moe/experts*", lvl)
                ctx = Ctx(policy=pol, mesh=mesh, decode=decode,
                          fsdp_params=fsdp)
                for body, x in xs.items():
                    with mesh:
                        y = jax.jit(lambda x: L._moe_ep(ctx, cfg, p, x))(
                            jnp.asarray(x).astype(adt))
                    res["|".join((arch, name, v, body))] = np.asarray(
                        y.astype(jnp.float32))
            # the routings each rank's body keeps, from the reference's
            # own router and _rank_in_expert
            tp = shape[1]
            for body, x in xs.items():
                b, s, dm = x.shape
                rows = b // shape[0]
                n_loc = rows * s
                small = not (n_loc %% tp == 0 and n_loc >= tp)
                kept = []
                for i in range(shape[0]):
                    x2 = jnp.asarray(x[i * rows:(i + 1) * rows].reshape(
                        n_loc, dm))
                    n = n_loc if small else n_loc // tp
                    for r in range(1 if small else tp):
                        _, eidx = L._router(cfg0, p["router"],
                                            x2[r * n:(r + 1) * n])
                        cap = max(8, int(np.ceil(n * cfg0.top_k
                                                 * cfg0.capacity_factor
                                                 / cfg0.n_experts)))
                        kept.append(np.asarray(L._rank_in_expert(
                            eidx.reshape(-1), cfg0.n_experts) < cap))
                res["|".join((arch, name, "kept", body))] = \\
                    np.concatenate(kept)
    np.savez(os.path.join(d, "jax_ep.npz"), **res)
    # the sharded trainer on a 1 x 1 mesh: two AdamW steps from the init,
    # with the reference's bf16 expert operands and with fp32 ones
    from repro.data.pipeline import TokenSource
    from repro.models.api import build_model
    from repro.optim.optimizers import adamw
    from repro.parallel.sharding import ShardingRules
    from repro.runtime import train_loop as tl
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    bf16_ffn = L._expert_ffn

    def fp32_ffn(ctx, recv, wg, wu, wd, psum_axes=None):
        hi = jax.lax.Precision.HIGHEST
        g = jnp.einsum("ecd,edf->ecf", recv, wg, precision=hi)
        u = jnp.einsum("ecd,edf->ecf", recv, wu, precision=hi)
        return jnp.einsum("ecf,efd->ecd", jax.nn.silu(g) * u, wd,
                          precision=hi).astype(recv.dtype)
    train = {}
    for arch, experts in [(a, e) for a in %(archs)r
                          for e in ("bf16", "fp32")]:
        L._expert_ffn = fp32_ffn if experts == "fp32" else bf16_ffn
        cfg = get_config(arch, smoke=True).replace(act_dtype="float32")
        # the mesh on the model: its moe_ffn takes _moe_ep from it
        m = build_model(cfg, mesh=mesh, policy=PrecisionPolicy(
            default="fp32"))
        st = tl.init_train_state(m, adamw(%(lr)r), jax.random.PRNGKey(0))
        init = jax.tree.map(np.asarray, st)
        src = TokenSource(cfg.vocab_size, 4, 16)
        rules = ShardingRules.default(mesh)
        losses = []
        with mesh:
            sh = tl.state_shardings(m, rules, "adamw")
            st = jax.device_put(st, sh)
            b0 = {k: jnp.asarray(v) for k, v in src.batch_at(0).items()}
            step = jax.jit(tl.make_train_step(m, adamw(%(lr)r)),
                           in_shardings=(sh, tl.batch_shardings(m, rules,
                                                                b0)))
            for i in range(2):
                st, met = step(st, {k: jnp.asarray(v) for k, v in
                                    src.batch_at(i).items()})
                losses.append(float(met["loss"]))
        train[arch, experts] = {
            "init": init, "losses": losses,
            "params": jax.tree.map(np.asarray, st["params"])}
    pickle.dump(train, open(os.path.join(d, "train.pkl"), "wb"))
    print("RESULT ok")
""") % {"variants": VARIANTS, "archs": ARCHS, "meshes": MESHES, "lr": LR}


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_ep")
    for arch in ARCHS:
        np.savez(d / f"{arch}_x.npz",
                 **_inputs(get_config(arch, smoke=True)))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(d)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = {"res": dict(np.load(d / "jax_ep.npz")), "moe": {}, "x": {},
           "train": pickle.load(open(d / "train.pkl", "rb"))}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True).replace(n_shared_experts=0)
        moe = L.MoE(cfg, "cpu")
        w = np.load(d / f"{arch}_moe.npz")
        moe.load_state_dict({k: torch.from_numpy(w[k]) for k in w.files})
        out["moe"][arch] = moe
        out["x"][arch] = {k: torch.from_numpy(v) for k, v in
                          np.load(d / f"{arch}_x.npz").items()}
    return out


def _kept(cfg, router, x, dp, tp):
    """The routings each rank's body keeps, in (data shard, rank) order."""
    b, s, d = x.shape
    rows = b // dp
    n_loc = rows * s
    small = L._ep_small(n_loc, tp)
    n = n_loc if small else n_loc // tp
    kept = []
    for i in range(dp):
        x2 = x[i * rows:(i + 1) * rows].reshape(n_loc, d)
        for r in range(1 if small else tp):
            _, slot, _, cap = L._ep_dispatch(cfg, router,
                                             x2[r * n:(r + 1) * n], 0,
                                             cfg.n_experts)
            kept.append((slot != cfg.n_experts * cap).numpy())
    return np.concatenate(kept)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_plain_ep_equals_jax(jax_ep, arch, mesh, variant):
    """Both bodies and the capacity-overflowing input: the same routings
    kept as the reference's bodies, the outputs within the stated
    tolerance."""
    dp, tp = map(int, mesh.split("x"))
    adt, _, lvl, decode = VARIANTS[variant]
    cfg = get_config(arch, smoke=True).replace(act_dtype=adt)
    moe = jax_ep["moe"][arch]
    dropped = 0
    for body, x in jax_ep["x"][arch].items():
        kept = _kept(cfg, moe.router, x, dp, tp)
        assert np.array_equal(kept, jax_ep["res"]["|".join(
            (arch, mesh, "kept", body))])
        dropped += int((~kept).sum())
        y = L.moe_ffn_ep_plain(Ctx(policy=_policy(lvl), decode=decode), cfg,
                               moe, x.to(cfg.adt), dp, tp).float().numpy()
        want = jax_ep["res"]["|".join((arch, mesh, variant, body))]
        tol = 1e-5 * np.abs(want).max()
        assert np.abs(y - want).max() <= tol, (body, np.abs(y - want).max())
    assert dropped > 0           # the skewed input overflows the capacity


# ------------------------------------------------------------ four ranks
WORKER = textwrap.dedent("""
    import contextlib, datetime, io, json, os, sys
    import torch, torch.distributed as dist
    rank, world, store, d = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import ShardedBatcher, TokenSource
    from repro_torch.launch import train as tlaunch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api as tapi, layers as L
    from repro_torch.models.common import Ctx
    from repro_torch.optim.optimizers import adamw
    from repro_torch.parallel.sharding import (ShardingRules,
                                               batch_placements, distribute)
    from repro_torch.quant.policy import PrecisionPolicy
    from repro_torch.runtime import train_loop as ttl
    spec = json.load(open(os.path.join(d, "spec.json")))
    xs = torch.load(os.path.join(d, "x.pt"))
    out = {}

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def policy(lvl):
        pol = PrecisionPolicy(default="fp32")
        return pol.with_rule("*moe/experts*", lvl) if lvl else pol

    for arch in spec["archs"]:
        cfg0 = get_config(arch, smoke=True).replace(act_dtype="float32")
        for shape in spec["meshes"]:
            mesh = make_host_mesh(*map(int, shape.split("x")), device="cpu")
            for v, (adt, fsdp, lvl, dec) in spec["variants"].items():
                cfg = cfg0.replace(act_dtype=adt)
                m = tapi.build_model(cfg, policy(lvl), "cpu", mesh=mesh,
                                     fsdp_params=fsdp)
                p = ttl.shard_params(m.init(0), ttl.state_shardings(
                    m, ShardingRules.default(mesh), "sgd",
                    fsdp=fsdp)["params"])
                ctx = m.ctx(decode=dec)
                for body, x in xs[arch].items():
                    xd = distribute(x.to(cfg.adt), mesh,
                                    batch_placements(mesh))
                    y = L.moe_ffn(ctx, cfg.replace(n_shared_experts=0),
                                  p.blocks[0].moe, xd)
                    out["|".join((arch, shape, v, body))] = full(y)
            # the layer's gradients (fp32)
            m = tapi.build_model(cfg0, policy(None), "cpu", mesh=mesh)
            p = ttl.shard_params(m.init(0), ttl.state_shardings(
                m, ShardingRules.default(mesh), "sgd")["params"])
            moe = p.blocks[0].moe
            for body in ("ep", "small"):
                x = xs[arch][body]
                xd = distribute(x, mesh, batch_placements(mesh))
                xd.requires_grad_(True)
                for w in (moe.router, moe.w_gate, moe.w_up, moe.w_down):
                    w.requires_grad_(True)
                    w.grad = None
                r = distribute(xs["weights"][arch][body], mesh,
                               batch_placements(mesh))
                (L._moe_ep(m.ctx(), cfg0, moe, xd) * r).sum().backward()
                out["|".join((arch, shape, "grad", body))] = {
                    "x": full(xd.grad), **{n: full(getattr(moe, n).grad)
                    for n in ("router", "w_gate", "w_up", "w_down")}}
        # the trainer on 2 x 2 under three remat policies, and with fp32
        # expert operands
        mesh = make_host_mesh(2, 2, "cpu")
        rules = ShardingRules.default(mesh)
        src = TokenSource(cfg0.vocab_size, 4, 16)
        bf16_ffn = L._expert_ffn

        def fp32_ffn(ctx, recv, wg, wu, wd):
            g = torch.bmm(recv, wg)
            return torch.bmm(torch.nn.functional.silu(g)
                             * torch.bmm(recv, wu), wd)
        for name, remat, ffn in (("none", "none", bf16_ffn),
                                 ("full", "full", bf16_ffn),
                                 ("dots+moe", "dots+moe", bf16_ffn),
                                 ("fp32_experts", "none", fp32_ffn)):
            L._expert_ffn = ffn
            m = tapi.build_model(cfg0.replace(remat=remat),
                                 PrecisionPolicy(default="fp32"), "cpu",
                                 mesh=mesh)
            state = ttl.shard_state(
                ttl.init_train_state(m, adamw(%(lr)r), 0),
                ttl.state_shardings(m, rules, "adamw"))
            step = ttl.make_train_step(m, adamw(%(lr)r))
            batcher = ShardedBatcher(src, rules, prefetch=False,
                                     device="cpu")
            losses = []
            for i in range(2):
                comm = CommDebugMode()
                with comm:
                    state, met = step(state, batcher.get(i))
                losses.append(float(met["loss"]))
            counts = {str(k).split(".")[-1]: n
                      for k, n in comm.get_comm_counts().items()}
            out["|".join((arch, "train", name))] = {
                "losses": losses, "a2a": counts.get("all_to_all_single", 0),
                "params": {n: full(t).detach() for n, t in
                           state["params"].named_parameters()},
                "placements": str(state["params"].blocks[0].moe.w_gate
                                  .placements)}
        L._expert_ffn = bf16_ffn
        # prefill and one decode step, the cache placed by the rules
        dec = xs["dec"]
        bsz, slen = dec["prompt"].shape
        for shape in ("2x2", "1x4"):
            m2 = make_host_mesh(*map(int, shape.split("x")), device="cpu")
            dm = tapi.build_model(cfg0, PrecisionPolicy(default="fp32"),
                                  "cpu", mesh=m2)
            r2 = ShardingRules.default(m2)
            dp = ttl.shard_params(dm.init(0), ttl.state_shardings(
                dm, r2, "sgd")["params"])
            c = ttl.place_cache(dm.init_cache(bsz, 2 * slen, torch.float32),
                                ttl.cache_shardings(dm, r2, bsz, 2 * slen))
            bp = batch_placements(m2)
            lg0, c = ttl.make_prefill_step(dm, 2 * slen)(
                dp, {"tokens": distribute(dec["prompt"], m2, bp)}, c)
            lg1, c = ttl.make_decode_step(dm)(
                dp, c, distribute(dec["next"], m2, bp))
            out["|".join((arch, "decode", shape))] = [full(lg0), full(lg1)]
            out["|".join((arch, "cache", shape))] = str(
                c["ckv" if cfg0.use_mla else "k"].placements)
            # the auxiliary loss on DTensors
            aux = L.moe_aux_loss(cfg0, dp.blocks[0].moe.router, distribute(
                xs[arch]["ep"], m2, bp))
            out["|".join((arch, "aux", shape))] = float(full(aux))
        # launch/train.py --mesh 2x2 on the smoke config
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--mesh", "2x2", "--steps", "2", "--batch", "4",
                          "--seq-len", "16",
                          "--ckpt-dir", os.path.join(d, "launch_" + arch)])
        if rank == 0:
            text = buf.getvalue()
            out["|".join((arch, "launch"))] = json.loads(
                text[text.index("{"):])
    if rank == 0:
        torch.save(out, os.path.join(d, "out.pt"))
    dist.destroy_process_group()
""") % {"lr": LR}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("ep_ranks")
    gen = torch.Generator().manual_seed(3)
    xs = {"dec": {"prompt": torch.randint(0, 256, (2, 8), generator=gen),
                  "next": torch.randint(0, 256, (2, 1), generator=gen)},
          "weights": {}}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        xs[arch] = {k: torch.from_numpy(v) for k, v in _inputs(cfg).items()}
        xs["weights"][arch] = {b: torch.randn(xs[arch][b].shape,
                                              generator=gen)
                               for b in ("ep", "small")}
    torch.save(xs, d / "x.pt")
    (d / "spec.json").write_text(json.dumps(
        {"archs": ARCHS, "meshes": MESHES, "variants": VARIANTS}))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), "4", str(d / "store"),
         str(d)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(4)]
    logs = [p.communicate(timeout=600) for p in procs]
    assert all(p.returncode == 0 for p in procs), logs[0][1][-3000:]
    return {"out": torch.load(d / "out.pt"), "x": xs}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ep_on_four_ranks_bit_equal_plain(ranks, arch, mesh, variant):
    """``moe_ffn`` on DTensors (the routed part: ``_moe_ep``) on four gloo
    ranks against the plain function at the same (dp, tp), bit for bit,
    for every input (FSDP-sharded experts gathered)."""
    dp, tp = map(int, mesh.split("x"))
    adt, _, lvl, decode = VARIANTS[variant]
    cfg = get_config(arch, smoke=True).replace(act_dtype=adt)
    p = tapi.build_model(cfg, _policy(lvl), "cpu").init(0)
    for body, x in ranks["x"][arch].items():
        want = L.moe_ffn_ep_plain(Ctx(policy=_policy(lvl), decode=decode),
                                  cfg, p.blocks[0].moe, x.to(cfg.adt),
                                  dp, tp)
        got = ranks["out"]["|".join((arch, mesh, variant, body))]
        assert torch.equal(got, want), body


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ep_gradients_equal_plain(ranks, arch, mesh):
    """The gradients of ``sum(r * _moe_ep(x))`` with respect to x, the
    router and the three expert weights, through both all-to-alls, the
    gather and the sum over ranks, against the plain function's."""
    dp, tp = map(int, mesh.split("x"))
    cfg = get_config(arch, smoke=True).replace(act_dtype="float32")
    p = tapi.build_model(cfg, _policy(None), "cpu").init(0)
    moe = p.blocks[0].moe
    for body in ("ep", "small"):
        x = ranks["x"][arch][body].clone().requires_grad_(True)
        ws = [moe.router, moe.w_gate, moe.w_up, moe.w_down]
        for w in ws:
            w.requires_grad_(True)
        y = L.moe_ffn_ep_plain(Ctx(policy=_policy(None)), cfg, moe, x, dp, tp)
        grads = torch.autograd.grad(
            (y * ranks["x"]["weights"][arch][body]).sum(), [x] + ws)
        got = ranks["out"]["|".join((arch, mesh, "grad", body))]
        for name, g in zip(("x", "router", "w_gate", "w_up", "w_down"),
                           grads):
            tol = 1e-6 * float(g.abs().max())
            assert float((got[name] - g).abs().max()) <= tol, (body, name)


def _rel(a: dict, b: dict) -> float:
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in a)
    den = sum(float((a[k].double() ** 2).sum()) for k in a)
    return (num / den) ** 0.5


def _readings(name: str, losses, want_losses, params, want_params):
    """The trainer's gaps, printed (``pytest -rP``) and returned: the
    largest relative loss difference and ``|Δθ|₂ / |θ|₂``."""
    dl = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    dp = _rel(want_params, params)
    print(f"{name}: losses {dl:.3e}, parameters {dp:.3e}")
    return dl, dp


def _unsharded_2x2(arch):
    """Two AdamW steps of the unsharded port routed through the plain
    function at (2, 2): (losses, parameters)."""
    cfg = get_config(arch, smoke=True).replace(act_dtype="float32")
    m = tapi.build_model(cfg, PrecisionPolicy(default="fp32"), "cpu")
    st = ttl.init_train_state(m, topt.adamw(LR), 0)
    step = ttl.make_train_step(m, topt.adamw(LR))
    src = TokenSource(cfg.vocab_size, 4, 16)
    losses = []
    with L.plain_ep_routing(2, 2):
        for i in range(2):
            st, met = step(st, {k: torch.from_numpy(v).long()
                                for k, v in src.batch_at(i).items()})
            losses.append(float(met["loss"]))
    return losses, {n: t.detach() for n, t in st["params"].named_parameters()}


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_trainer_2x2_equals_unsharded_plain_ep(ranks, arch):
    """Two AdamW steps with clipping on a 2 x 2 gloo mesh against the
    unsharded port routed through the plain function at (2, 2); the
    experts stay sharded over ``model``."""
    losses, want = _unsharded_2x2(arch)
    got = ranks["out"]["|".join((arch, "train", "none"))]
    dl, dp = _readings(f"{arch} 2x2", got["losses"], losses,
                       got["params"], want)
    assert dl <= 5e-5 and dp <= 5e-4
    assert got["placements"].endswith("Shard(dim=0))")   # over model


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_trainer_2x2_fp32_experts_within_1e6(ranks, arch, monkeypatch):
    """The 2 x 2 trainer with fp32 expert operands in both runs holds the
    dense trainer's 1e-6 (losses and ``|Δθ|₂ / |θ|₂``): the bf16 operands
    are what the test above needs its tolerance for."""
    monkeypatch.setattr(L, "_expert_ffn", _expert_ffn_fp32)
    losses, want = _unsharded_2x2(arch)
    got = ranks["out"]["|".join((arch, "train", "fp32_experts"))]
    dl, dp = _readings(f"{arch} 2x2 fp32 experts", got["losses"], losses,
                       got["params"], want)
    assert dl <= 1e-6 and dp <= 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_moe_remat_bit_equal_and_saves_the_dispatch(ranks, arch):
    """``"dots+moe"`` trains bit for bit as ``"none"`` and ``"full"``; a
    step's all-to-alls: 2 a layer forward and 2 backward, plus the 2 of
    the recompute under ``"full"`` and only the combine's under
    ``"dots+moe"`` (the dispatch's output is kept)."""
    out = ranks["out"]
    none = out["|".join((arch, "train", "none"))]
    n_layers = get_config(arch, smoke=True).n_layers
    assert none["a2a"] == 4 * n_layers
    for remat, extra in (("full", 2), ("dots+moe", 1)):
        got = out["|".join((arch, "train", remat))]
        assert got["losses"] == none["losses"]
        assert all(torch.equal(got["params"][k], none["params"][k])
                   for k in none["params"])
        assert got["a2a"] == (4 + extra) * n_layers


@pytest.mark.parametrize("shape", ["2x2", "1x4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_on_mesh_equals_plain_ep(ranks, arch, shape):
    """A prefill (2 x 8: the all-to-all body) and one decode step (2 x 1:
    the replicated-routing body) with the cache placed by the rules —
    its sequence over ``model`` (GQA's K/V, MLA's compressed cache) —
    against the unsharded port routed through the plain function at the
    same (dp, tp)."""
    cfg = get_config(arch, smoke=True).replace(act_dtype="float32")
    m = tapi.build_model(cfg, PrecisionPolicy(default="fp32"), "cpu")
    p = m.init(0)
    dec = ranks["x"]["dec"]
    with L.plain_ep_routing(*map(int, shape.split("x"))):
        c = m.init_cache(2, 16, torch.float32)
        l0, c = m.prefill(p, {"tokens": dec["prompt"]}, c)
        l1, _ = m.decode_step(p, c, dec["next"])
    g0, g1 = ranks["out"]["|".join((arch, "decode", shape))]
    for got, want in ((g0, l0), (g1, l1)):
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
    cache = ranks["out"]["|".join((arch, "cache", shape))]
    assert cache.split(", ")[1].startswith("Shard(dim=2")   # (L, B, S…)


@pytest.mark.parametrize("shape", ["2x2", "1x4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_aux_loss_on_mesh_equals_unsharded(ranks, arch, shape):
    """``moe_aux_loss`` of DTensors (each rank's routings summed, the sums
    partial over the data axes) against the unsharded function, which
    ``test_torch_moe.py`` holds to the reference (fp32, 1e-6)."""
    cfg = get_config(arch, smoke=True).replace(act_dtype="float32")
    p = tapi.build_model(cfg, _policy(None), "cpu").init(0)
    want = float(L.moe_aux_loss(cfg, p.blocks[0].moe.router,
                                ranks["x"][arch]["ep"]))
    got = ranks["out"]["|".join((arch, "aux", shape))]
    assert abs(got - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_mesh_2x2_moe(ranks, arch):
    """``launch/train.py --arch <MoE> --smoke --mesh 2x2`` on the four gloo
    ranks runs its steps with finite losses."""
    got = ranks["out"]["|".join((arch, "launch"))]
    assert got["mesh"] == [2, 2] and got["devices"] == 4
    assert got["steps_run"] == 2
    assert np.isfinite(got["first_loss"]) and np.isfinite(got["final_loss"])


# ------------------------------------------ the 1 x 1 mesh against JAX
def _train_1x1(ref: dict, arch: str, store):
    """Two AdamW steps from the reference's init on a one-rank 1 x 1 mesh
    (``store``: the gloo group's file) and unsharded, routed through the
    plain function at (1, 1): (mesh losses, mesh parameters, unsharded
    parameters)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import ShardingRules
    tc = get_config(arch, smoke=True).replace(act_dtype="float32")
    src = TokenSource(tc.vocab_size, 4, 16)

    def state(model):
        return state_from_jax(jax.tree.map(_tensor, ref["init"]), model)

    um = tapi.build_model(tc, PrecisionPolicy(default="fp32"), "cpu")
    ust = state(um)
    ustep = ttl.make_train_step(um, topt.adamw(LR))
    with L.plain_ep_routing(1, 1):
        for i in range(2):
            ust, _ = ustep(ust, {k: torch.from_numpy(v).long()
                                 for k, v in src.batch_at(i).items()})
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1, "cpu")
        tm = tapi.build_model(tc, PrecisionPolicy(default="fp32"), "cpu",
                              mesh=mesh)
        rules = ShardingRules.default(mesh)
        st = ttl.shard_state(state(tm), ttl.state_shardings(tm, rules,
                                                            "adamw"))
        step = ttl.make_train_step(tm, topt.adamw(LR))
        batcher = ShardedBatcher(src, rules, prefetch=False, device="cpu")
        losses = []
        for i in range(2):
            st, met = step(st, batcher.get(i))
            losses.append(float(met["loss"]))
        got = {k: v.full_tensor().detach()
               for k, v in st["params"].named_parameters()}
    finally:
        dist.destroy_process_group()
    return losses, got, {k: v.detach()
                         for k, v in ust["params"].named_parameters()}


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_trainer_1x1_equals_jax_sharded(jax_ep, arch, tmp_path):
    """Two AdamW steps on a one-rank 1 x 1 mesh from the reference's init
    against the reference's sharded step on its 1 x 1 mesh (expert
    parallelism at tp = 1 in both packages), and bit for bit against the
    unsharded port routed through the plain function at (1, 1)."""
    ref = jax_ep["train"][arch, "bf16"]
    losses, got, unsharded = _train_1x1(ref, arch, tmp_path / "store")
    for k, v in unsharded.items():
        assert torch.equal(got[k], v), k
    dl, dp = _readings(f"{arch} 1x1 vs JAX", losses, ref["losses"], got,
                       params_from_jax(ref["params"]))
    assert dl <= 5e-5 and dp <= 5e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_trainer_1x1_fp32_experts_within_1e5_of_jax(jax_ep, arch,
                                                         tmp_path,
                                                         monkeypatch):
    """The 1 x 1 trainer with fp32 expert operands in both packages holds
    the dense trainer's 1e-5 against the reference (losses and
    ``|Δθ|₂ / |θ|₂``)."""
    monkeypatch.setattr(L, "_expert_ffn", _expert_ffn_fp32)
    ref = jax_ep["train"][arch, "fp32"]
    losses, got, _ = _train_1x1(ref, arch, tmp_path / "store")
    dl, dp = _readings(f"{arch} 1x1 vs JAX, fp32 experts", losses,
                       ref["losses"], got, params_from_jax(ref["params"]))
    assert dl <= 1e-5 and dp <= 1e-5


# ---------------------------------------------------------- the dry run
DRY = textwrap.dedent("""
    import json
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.roofline import roofline
    out = {}
    for arch, shape in (("granite_moe_1b_a400m", "train_4k"),
                        ("granite_moe_1b_a400m", "decode_32k"),
                        ("deepseek_v2_236b", "decode_32k")):
        lowered, mesh, model, aux = D.lower_cell(arch, SHAPES[shape])
        r = roofline(lowered.compile(), mesh,
                     model_flops=D._cell_model_flops(arch, SHAPES[shape]))
        out[arch + "|" + shape] = {"counts": r["collective_counts"],
                                   "bytes": r["collective_bytes_by_kind"],
                                   "fits": r["fits_hbm"],
                                   "flops": r["hlo_flops_per_chip"],
                                   "fsdp": aux["fsdp"]}
    print("RESULT " + json.dumps(out))
""")


def test_lower_cell_moe_on_placeholder_world():
    """granite-moe-1b-a400m and deepseek-v2-236b at full width, rank 0 of
    the placeholder 16 x 16: train_4k reaches the all-to-all body (its
    exchanges counted and sized), decode_32k (8 rows a data shard, tp =
    16) the replicated-routing one (no all-to-all; the sum over
    ``model``); DeepSeek-V2 under FSDP; every cell fits 80 GB."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", DRY], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [t for t in r.stdout.splitlines() if t.startswith("RESULT ")][0]
    out = json.loads(line[len("RESULT "):])
    tr = out["granite_moe_1b_a400m|train_4k"]
    # forward 2, the "dots" recompute 2, backward 2 — a layer
    assert tr["counts"]["all-to-all"] == 24 * 6
    assert tr["bytes"]["all-to-all"] > 0
    for key in ("granite_moe_1b_a400m|decode_32k",
                "deepseek_v2_236b|decode_32k"):
        assert out[key]["counts"]["all-to-all"] == 0
        assert out[key]["counts"]["all-reduce"] > 0
    assert out["deepseek_v2_236b|decode_32k"]["fsdp"]
    assert all(v["fits"] and v["flops"] > 0 for v in out.values())
