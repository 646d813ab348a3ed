"""Prebuilt design flows (paper Fig. 2): single-O-task strategies and the
combined cross-stage strategies, in any order — the point of the paper is
that these are a few lines to assemble and re-order.

    flow = pruning_strategy("jet_dnn")            # Fig. 2(a)
    flow = combined_strategy("jet_dnn", "SPQ")    # Fig. 2(b)
    flow = combined_strategy("jet_dnn", "PSQ")    # Fig. 2(c) variant
    flow = serve_strategy("qwen2-7b", device="cpu")   # → TUNE → SERVE
    meta = run(flow)

The JAX package's ``core/strategies.py``: :data:`O_TASKS` holds PRUNING
(``"P"``), SCALING (``"S"``), QUANTIZATION (``"Q"``), SHARDING-SEARCH
(``"H"``), TUNE (``"T"``) and SERVE (``"V"``), and :func:`dryrun_flow`
expresses the dry run as ModelGen → [O-tasks] → Lower → Compile →
Roofline.  Flows run on the card unless MODEL-GEN is given
``device="cpu"``; the O-tasks run where MODEL-GEN's model lives.  The
dry-run flow's MODEL-GEN builds on the ``meta`` device (shapes only).
"""

from __future__ import annotations

from typing import Any

from repro_torch.core.flow import DesignFlow
from repro_torch.core.metamodel import MetaModel
from repro_torch.tasks.lower import Compile, Lower, Roofline
from repro_torch.tasks.model_gen import ModelGen
from repro_torch.tasks.pruning import Pruning
from repro_torch.tasks.quantization import Quantization
from repro_torch.tasks.scaling import Scaling
from repro_torch.tasks.serve import Serve
from repro_torch.tasks.sharding_search import ShardingSearch
from repro_torch.tasks.tune import Tune

O_TASKS = {"P": Pruning, "S": Scaling, "Q": Quantization,
           "H": ShardingSearch, "T": Tune, "V": Serve}


def pruning_strategy(model: str = "jet_dnn", *, device=None,
                     **params) -> DesignFlow:
    """Paper Fig. 2(a): MODEL-GEN → PRUNING."""
    flow = DesignFlow(f"pruning({model})")
    flow.chain(ModelGen(model=model, device=device), Pruning(**params))
    return flow


def scaling_strategy(model: str = "jet_dnn", *, device=None,
                     **params) -> DesignFlow:
    flow = DesignFlow(f"scaling({model})")
    flow.chain(ModelGen(model=model, device=device), Scaling(**params))
    return flow


def quantization_strategy(model: str = "jet_dnn", *, device=None,
                          **params) -> DesignFlow:
    flow = DesignFlow(f"quantization({model})")
    flow.chain(ModelGen(model=model, device=device), Quantization(**params))
    return flow


def tune_strategy(model: str = "jet_dnn", **params) -> DesignFlow:
    """MODEL-GEN → TUNE: autotune the kernels' launch configs for the
    shapes this model executes (kernels/autotune.py)."""
    flow = DesignFlow(f"tune({model})")
    flow.chain(ModelGen(model=model), Tune(**params))
    return flow


def serve_strategy(model: str = "qwen2-7b",
                   model_params: dict | None = None,
                   tune_params: dict | None = None,
                   serve_params: dict | None = None, *,
                   device=None) -> DesignFlow:
    """MODEL-GEN → TUNE → SERVE (``T → V``): tune the kernels' launch
    configs for the shapes this model executes, then search the joint
    serving-plan space on a traffic profile — the deployment readbacks
    (page size, segment cadence) flow from TUNE to SERVE through the
    persisted autotune cache, and the winner ships as a ServingPlan JSON
    artifact.  ``device`` (the card unless ``"cpu"``) goes to MODEL-GEN
    and TUNE unless their params name one; SERVE runs where the model
    lives."""
    model_params = dict(model_params or {})
    tune_params = dict(tune_params or {})
    if device is not None:
        model_params.setdefault("device", device)
        tune_params.setdefault("device", device)
    flow = DesignFlow(f"serve({model})")
    flow.chain(ModelGen(model=model, **model_params),
               Tune(**tune_params),
               Serve(**(serve_params or {})))
    return flow


def combined_strategy(model: str = "jet_dnn", order: str = "SPQ",
                      task_params: dict[str, dict] | None = None,
                      model_params: dict | None = None) -> DesignFlow:
    """Combined cross-stage strategy with O-tasks in ``order`` — e.g.
    "SPQ" = scaling → pruning → quantization (paper Fig. 2(b)); "PS" =
    pruning → scaling (Fig. 5(b)).  Reordering is a one-char edit — the
    customizability claim of the paper."""
    task_params = task_params or {}
    flow = DesignFlow(f"{'+'.join(order)}({model})")
    tasks: list[Any] = [ModelGen(model=model, **(model_params or {}))]
    for ch in order:
        tasks.append(O_TASKS[ch](**task_params.get(ch, {})))
    flow.chain(*tasks)
    return flow


def dryrun_flow(arch: str, shape: str = "train_4k",
                multi_pod: bool = False, o_tasks: str = "",
                task_params: dict[str, dict] | None = None) -> DesignFlow:
    """Deliverables (e)/(g) as a MetaML flow:
    ModelGen → [O-tasks] → Lower → Compile → Roofline."""
    task_params = task_params or {}
    flow = DesignFlow(f"dryrun({arch}@{shape})")
    tasks: list[Any] = [ModelGen(model=arch, train_en=False, device="meta")]
    for ch in o_tasks:
        tasks.append(O_TASKS[ch](**task_params.get(ch, {})))
    tasks += [Lower(shape=shape, multi_pod=multi_pod), Compile(),
              Roofline()]
    flow.chain(*tasks)
    return flow


def run(flow: DesignFlow, cfg: dict | None = None) -> MetaModel:
    return flow.execute(MetaModel(cfg))
