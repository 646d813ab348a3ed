"""Multi-pod dry run: one rank's program of every (arch x shape x mesh)
cell, lowered and "compiled" without the machines: the port of the JAX
package's ``launch/dryrun.py``.

For each cell this:

  1. starts a placeholder world of 256 or 512 ranks (``launch/mesh.py``:
     the ``"fake"`` backend, the counterpart of the reference's forced
     host device count) and builds the production mesh on it, 16 x 16
     ("data", "model") or 2 x 16 x 16 ("pod", "data", "model");
  2. builds the model and the logical-axis shardings, and rank 0's
     shards of the parameters, moments, inputs and cache as DTensors on
     the ``meta`` device (no allocation);
  3. "lowers": binds the REAL train / prefill / decode step to them
     (:class:`Lowered`);
  4. "compiles": runs that step once on the meta tensors under
     ``launch/roofline.py::DryRunCounter`` and ``CommDebugMode`` — the
     sharding decisions, every redistribution DTensor inserts and every
     op without a sharding strategy surface here — and records FLOPs,
     bytes, collectives and memory per chip (:class:`Compiled`);
  5. writes the roofline terms, with the H100's constants, to
     ``benchmarks/results/dryrun_torch_<mesh>.json``.

The placeholder group's collectives move no data, so a value computed
after one is garbage: the dry run reads shapes and counts only.

The reference corrects XLA's cost analysis, which counts a scanned
layer's body once, by extrapolating 1- and 2-unit traces
(``probe_layer_costs``).  The port runs every layer in Python and the
counters see each one, so its counts need no correction: ``roofline``'s
``scan_corrected`` is always False and its ``raw_*`` terms equal the
traced ones.  On a
card, :func:`execute_cell` runs the same rank-0 program on real tensors
(collectives still stubbed) to hold :class:`Compiled`'s memory estimate
against the card's allocator.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
      --shape decode_32k [--multi-pod] [--fsdp] [--out results.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Callable

import torch

from repro_torch.configs.base import (SHAPES, ShapeSpec, active_params,
                                      model_flops_per_token, shape_applicable,
                                      total_params)
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_production_mesh, placeholder_world
from repro_torch.launch.roofline import (FUNCOL_KIND, CollectiveStats,
                                         DryRunCounter, format_roofline,
                                         roofline)
from repro_torch.models import transformer as T
from repro_torch.models.api import DEFAULT_EXEMPT, build_model
from repro_torch.optim.optimizers import adamw, tree_map
from repro_torch.parallel.sharding import ShardingRules, distribute
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.runtime.train_loop import (batch_shardings, cache_shardings,
                                            make_decode_step,
                                            make_prefill_step,
                                            make_train_step, place,
                                            place_cache, shard_params,
                                            state_shardings)

# archs whose params+moments need FSDP sharding over the dp axes
FSDP_ARCHS = {"deepseek-v2-236b", "qwen1.5-110b", "chameleon-34b"}

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "benchmarks", "results")


@dataclasses.dataclass
class MemoryAnalysis:
    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int


@dataclasses.dataclass
class Compiled:
    """One rank's counted program (``launch/roofline.py``)."""
    flops: float
    bytes: float
    collectives: CollectiveStats
    comm_counts: dict[str, int]
    memory: MemoryAnalysis
    seconds: float

    def cost_analysis(self) -> dict[str, float]:
        return {"flops": self.flops, "bytes accessed": self.bytes}

    def memory_analysis(self) -> MemoryAnalysis:
        return self.memory


@dataclasses.dataclass
class Lowered:
    """A cell's step bound to rank 0's sharded arguments: ``run()``
    executes it once; ``args`` are the argument DTensors (their local
    bytes are the program's arguments)."""
    run: Callable[[], Any]
    args: list

    def compile(self) -> Compiled:
        """Run the program once on its meta arguments under the
        counters."""
        from torch.distributed.tensor.debug import CommDebugMode
        counter = DryRunCounter()
        locals_ = [a.to_local() for a in self.args]
        arg_bytes = counter.hold_args(locals_)
        comm = CommDebugMode()
        t0 = time.perf_counter()
        with comm, counter:
            out = self.run()
        outs = [t for t in _leaves(out) if isinstance(t, torch.Tensor)]
        out_bytes = sum(_local(t).numel() * t.element_size() for t in outs)
        counts = {str(op).split(".")[-1]: n
                  for op, n in comm.get_comm_counts().items()}
        coll = counter.collectives()
        by_kind = dict.fromkeys(coll.counts, 0)
        for name, n in counts.items():
            by_kind[FUNCOL_KIND.get(name, name)] = \
                by_kind.get(FUNCOL_KIND.get(name, name), 0) + n
        return Compiled(
            flops=counter.flops, bytes=counter.bytes,
            collectives=CollectiveStats(coll.operand_bytes, by_kind),
            comm_counts=counts,
            memory=MemoryAnalysis(arg_bytes, out_bytes, counter.peak),
            seconds=time.perf_counter() - t0)


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _dtensors(tree) -> list:
    from torch.distributed.tensor import DTensor
    return [t for t in _leaves(tree) if isinstance(t, DTensor)]


@torch.no_grad()
def _real(t, device, gen=None):
    """A meta DTensor with real local storage on ``device``: small
    normals from ``gen``, or zeros without one."""
    from torch.distributed.tensor import DTensor
    loc = t.to_local()
    new = (torch.randn(loc.shape, generator=gen, device=device) * 0.02
           if gen is not None else torch.zeros(loc.shape, device=device))
    return DTensor.from_local(new.to(loc.dtype), t.device_mesh, t.placements,
                              run_check=False)


def _real_tree(tree, device):
    """:func:`_real` (zeros) over the DTensors of a nested dict / list;
    host values (``pos``, ``step``) kept."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: _real_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_real_tree(v, device) for v in tree]
    return _real(tree, device) if isinstance(tree, DTensor) else tree


def _pos_last(cache: dict, last: int) -> None:
    """Every host ``pos`` of the cache at ``last``: the decode writes the
    last slot and attends every one."""
    for k, v in cache.items():
        if isinstance(v, dict):
            _pos_last(v, last)
        elif k == "pos" and isinstance(v, torch.Tensor):
            v.fill_(last)
        elif k == "pos":
            cache[k] = last


def lower_cell(arch: str, shape: ShapeSpec, *, multi_pod: bool = False,
               fsdp: bool | None = None,
               rules_overrides: dict | None = None,
               cache_seq_axis: str | None = None,
               microbatches: int = 1,
               grad_compression: bool = False,
               remat: str | None = None,
               zero1: bool = False,
               policy_rules: list | None = None,
               cfg_overrides: dict | None = None,
               device: str = "meta"):
    """Returns (lowered, mesh, model, aux) — compile is the caller's call.

    Rank 0's arguments live on ``device``: ``"meta"`` for the dry run, or
    a card for :func:`execute_cell` (random weights from seed 0, a zero
    cache).  With ``grad_compression`` a train cell's state carries the
    fp32 residuals, placed like the parameters and counted among the
    arguments, as the reference's.  The reference's ``donate`` and
    ``moe_fsdp_mode`` have no counterpart: the port's steps update their
    state in place, and its expert parallelism gathers FSDP-sharded
    experts in both of the reference's modes
    (``models/layers.py::_moe_ep``)."""
    cfg = get_config(arch)
    if remat is not None:
        cfg = cfg.replace(remat=remat)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    placeholder_world(512 if multi_pod else 256)
    mesh_dev = "cpu" if device == "meta" else device
    mesh = make_production_mesh(multi_pod=multi_pod, device=mesh_dev)
    use_fsdp = fsdp if fsdp is not None else (cfg.name in FSDP_ARCHS)
    overrides = dict(rules_overrides or {})
    if cache_seq_axis is not None:
        overrides["cache_seq"] = cache_seq_axis
    rules = ShardingRules.default(mesh, overrides=overrides)
    policy = None
    if policy_rules:
        policy = PrecisionPolicy(default="bf16", exempt=DEFAULT_EXEMPT,
                                 rules=[tuple(r) for r in policy_rules])
    model = build_model(cfg, policy, device=mesh_dev, mesh=mesh,
                        fsdp_params=use_fsdp)
    specs = model.input_specs(shape)
    opt_name = "adamw" if shape.kind == "train" else "sgd"
    sshard = state_shardings(model, rules, opt_name, fsdp=use_fsdp,
                             zero1=zero1)
    params = shard_params((T.EncDec if cfg.enc_dec else T.LM)(cfg, "meta"),
                          sshard["params"])
    bshard = batch_shardings(model, rules, specs)
    batch = {k: distribute(v, bshard[k].mesh, bshard[k].placements)
             for k, v in specs.items()}
    args = _dtensors(dict(params.named_parameters())) + _dtensors(batch)
    b = shape.global_batch
    if shape.kind == "train":
        tree = params.param_tree(per_block=True)
        f32 = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                             device="meta"), tree)
        opt = {"step": 0, "m": place(f32, sshard["opt"]["m"]),
               "v": place(f32, sshard["opt"]["v"])}
        state = {"params": params, "opt": opt}
        args += _dtensors(opt)
        if grad_compression:
            state["residuals"] = place(f32, sshard["params"])
            args += _dtensors(state["residuals"])
        step_fn = make_train_step(model, adamw(3e-4),
                                  grad_compression=grad_compression,
                                  microbatches=microbatches)

        def run():
            return step_fn(state, batch)[1]
    elif shape.kind == "prefill":
        cshard = cache_shardings(model, rules, b, shape.seq_len)
        step_fn = make_prefill_step(model, shape.seq_len)

        def run():
            return step_fn(params, batch, cache=place_cache(
                model.abstract_cache(b, shape.seq_len)[0], cshard))
    else:
        cshard = cache_shardings(model, rules, b, shape.seq_len)
        cache = place_cache(model.abstract_cache(b, shape.seq_len)[0],
                              cshard)
        _pos_last(cache, shape.seq_len - 1)
        args += _dtensors(cache)
        step_fn = make_decode_step(model)

        def run():
            return step_fn(params, cache, batch["tokens"])
    if device != "meta":      # rank 0's arguments for real (seed 0)
        gen = torch.Generator(device=device).manual_seed(0)
        for mod in params.modules():
            for name, t in list(mod._parameters.items()):
                mod._parameters[name] = torch.nn.Parameter(
                    _real(t, device, gen), requires_grad=False)
        batch = _real_tree(batch, device)
        if shape.kind == "train":
            state["opt"] = _real_tree(state["opt"], device)
            if grad_compression:
                state["residuals"] = _real_tree(state["residuals"], device)
        elif shape.kind == "decode":
            cache = _real_tree(cache, device)
        args = None
    aux = {"fsdp": use_fsdp, "fallbacks": sorted(set(rules.fallbacks))}
    return Lowered(run=run, args=args), mesh, model, aux


def execute_cell(arch: str, shape: ShapeSpec, *, device="cuda",
                 reps: int = 3, **kw) -> dict:
    """Rank 0's program of a cell run for real on ``device`` (a card):
    its arguments allocated there, the placeholder group's collectives
    stubbed (their outputs unwritten: no value is checked).  Returns the
    step's median milliseconds over ``reps`` after one warm-up, the
    card's peak allocated bytes during it, and the bytes allocated
    before the step (the arguments)."""
    import statistics
    lowered, mesh, model, aux = lower_cell(arch, shape, device=device, **kw)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(reps + 1):
        t0 = time.perf_counter()
        lowered.run()
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return {"ms": statistics.median(times), "ms_all": times,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "arg_bytes": base, "collectives": "stubbed", **aux}


def _cell_model_flops(arch: str, shape: ShapeSpec) -> float:
    cfg = get_config(arch)
    per_tok = model_flops_per_token(cfg)
    if shape.kind == "train":
        return per_tok * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        # forward only
        return per_tok / 3.0 * shape.seq_len * shape.global_batch
    return per_tok / 3.0 * shape.global_batch  # one token per request


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             verbose: bool = True, **kw) -> dict:
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    ok, why = shape_applicable(cfg, shape)
    rec: dict = {"arch": arch, "shape": shape_name,
                 "mesh": "2x16x16" if multi_pod else "16x16",
                 "params_total": total_params(cfg),
                 "params_active": active_params(cfg)}
    if not ok:
        rec.update(status="skipped", reason=why)
        if verbose:
            print(f"[{arch} x {shape_name}] SKIP: {why}")
        return rec
    t0 = time.time()
    try:
        lowered, mesh, model, aux = lower_cell(arch, shape,
                                               multi_pod=multi_pod, **kw)
        t_lower = time.time() - t0
        compiled = lowered.compile()
        t_compile = time.time() - t0 - t_lower
        r = roofline(compiled, mesh,
                     model_flops=_cell_model_flops(arch, shape))
        rec.update(status="ok", roofline=r, lower_s=t_lower,
                   compile_s=t_compile, comm_counts=compiled.comm_counts,
                   **aux)
        if verbose:
            print(format_roofline(f"{arch} x {shape_name} x {rec['mesh']}",
                                  r))
            print(f"  lower {t_lower:.1f}s compile {t_compile:.1f}s "
                  f"fallbacks={aux['fallbacks']}")
    except Exception as e:  # noqa: BLE001
        rec.update(status="error", error=repr(e),
                   traceback=traceback.format_exc())
        if verbose:
            print(f"[{arch} x {shape_name}] ERROR: {e}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--fsdp", action="store_true", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shape) for arch in ARCH_IDS for shape in SHAPES]
    else:
        archs = [args.arch] if args.arch else ARCH_IDS
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [(a, s) for a in archs for s in shapes]

    results = []
    for arch, shape in cells:
        results.append(run_cell(arch, shape, multi_pod=args.multi_pod,
                                fsdp=args.fsdp))

    out = args.out
    if out is None:
        os.makedirs(RESULTS_DIR, exist_ok=True)
        suffix = "multipod" if args.multi_pod else "singlepod"
        out = os.path.join(RESULTS_DIR, f"dryrun_torch_{suffix}.json")
    existing = []
    if os.path.exists(out):
        with open(out) as f:
            existing = json.load(f)
    keyed = {(r["arch"], r["shape"], r["mesh"]): r for r in existing}
    for r in results:
        r.pop("traceback", None)
        keyed[(r["arch"], r["shape"], r["mesh"])] = r
    with open(out, "w") as f:
        json.dump(list(keyed.values()), f, indent=1)
    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"] == "skipped")
    n_err = len(results) - n_ok - n_skip
    print(f"\n== dry-run: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"-> {out}")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
