"""Lowering / compilation λ-tasks — the stack's analogues of HLS4ML and
VIVADO-HLS (paper Table I): the port of the JAX package's
``tasks/lower.py`` on ``launch/dryrun.py``.

Lower    (DNN → LOWERED):  one rank's program of a cell — the sharded
                           abstract parameters, moments, inputs and cache
                           bound to the REAL step (``lower_cell``).
Compile  (LOWERED → COMPILED): runs that program once on ``meta`` tensors
                           under the dry run's counters: FLOPs, bytes,
                           collectives, and memory per chip —
                           ``arg_bytes``, the arguments' local bytes, and
                           ``temp_bytes``, the peak of the live bytes the
                           program allocates beyond them (each new storage
                           counted until freed, ``DryRunCounter``).
Roofline (COMPILED → COMPILED): annotates the roofline terms with the
                           H100's constants (the "tool report" of the RTL
                           stage).

The shape and mesh come from the meta-model CFG (``Lower.shape``,
``Lower.multi_pod`` …), as the paper's λ-tasks read the FPGA part number
and clock period from the CFG.
"""

from __future__ import annotations

from repro_torch.configs.base import SHAPES, shape_applicable
from repro_torch.core.metamodel import (LEVEL_COMPILED, LEVEL_DNN,
                                        LEVEL_LOWERED, MetaModel)
from repro_torch.core.task import LambdaTask, TaskError
from repro_torch.launch.roofline import format_roofline, roofline


class Lower(LambdaTask):
    n_in = 1
    n_out = 1
    defaults = {
        "shape": "train_4k",
        "multi_pod": False,
        "fsdp": None,
        "microbatches": 1,
        "remat": None,
        "rules_overrides": None,
        "cache_seq_axis": None,
        "grad_compression": False,
    }

    def execute(self, meta: MetaModel, inputs):
        from repro_torch.launch.dryrun import lower_cell
        art = meta.model(inputs[0])
        if art.level != LEVEL_DNN:
            raise TaskError(f"Lower expects a DNN artifact, got {art.level}")
        handle = art.payload
        if handle.kind != "lm":
            raise TaskError("Lower operates on LM handles (bench models "
                            "are evaluated at the DNN level)")
        shape = SHAPES[self.param(meta, "shape")]
        cfg = handle.model.cfg
        ok, why = shape_applicable(cfg, shape)
        if not ok:
            raise TaskError(f"shape {shape.name} inapplicable: {why}")
        kw = dict(multi_pod=self.param(meta, "multi_pod"),
                  fsdp=self.param(meta, "fsdp"),
                  microbatches=self.param(meta, "microbatches"),
                  remat=self.param(meta, "remat"),
                  rules_overrides=self.param(meta, "rules_overrides"),
                  cache_seq_axis=self.param(meta, "cache_seq_axis"),
                  grad_compression=self.param(meta, "grad_compression"))
        lowered, mesh, model, aux = lower_cell(handle.name, shape, **kw)
        payload = {"lowered": lowered, "mesh": mesh, "model": model,
                   "shape": shape, "aux": aux}
        out = meta.add_model(f"{handle.name}@{shape.name}", LEVEL_LOWERED,
                             payload, parent=inputs[0],
                             metrics={"shape": shape.name, **aux})
        return [out]


class Compile(LambdaTask):
    n_in = 1
    n_out = 1

    def execute(self, meta: MetaModel, inputs):
        art = meta.model(inputs[0])
        if art.level != LEVEL_LOWERED:
            raise TaskError("Compile expects a LOWERED artifact")
        payload = dict(art.payload)
        compiled = payload["lowered"].compile()
        payload["compiled"] = compiled
        mem = compiled.memory_analysis()
        metrics = dict(art.metrics)
        metrics["temp_bytes"] = mem.temp_size_in_bytes
        metrics["arg_bytes"] = mem.argument_size_in_bytes
        metrics["peak_bytes_per_chip"] = (mem.argument_size_in_bytes
                                          + mem.temp_size_in_bytes)
        out = meta.add_model(art.name + ":rtl", LEVEL_COMPILED, payload,
                             parent=inputs[0], metrics=metrics)
        return [out]


class Roofline(LambdaTask):
    """Annotate a COMPILED artifact with roofline terms (report stage)."""
    n_in = 1
    n_out = 1
    defaults = {"model_flops": None, "verbose": True}

    def execute(self, meta: MetaModel, inputs):
        from repro_torch.launch.dryrun import _cell_model_flops
        art = meta.model(inputs[0])
        if art.level != LEVEL_COMPILED:
            raise TaskError("Roofline expects a COMPILED artifact")
        p = art.payload
        mf = self.param(meta, "model_flops")
        if mf is None:
            mf = _cell_model_flops(p["model"].cfg.name, p["shape"])
        r = roofline(p["compiled"], p["mesh"], model_flops=mf)
        art.metrics.update(roofline=r)
        art.reports["roofline"] = format_roofline(art.name, r)
        if self.param(meta, "verbose"):
            print(art.reports["roofline"])
        meta.set("roofline.last", r)
        meta.record("roofline", artifact=art.name,
                    dominant=r["dominant"], bound_s=r["bound_s"])
        return [inputs[0]]
