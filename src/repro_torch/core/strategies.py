"""Prebuilt design flows (paper Fig. 2): the point of the paper is that
these are a few lines to assemble and re-order.

    flow = tune_strategy("jet_dnn", device="cpu")   # MODEL-GEN → TUNE
    flow = combined_strategy("qwen2-7b", "TV")
    flow = serve_strategy("qwen2-7b", device="cpu")   # → TUNE → SERVE
    meta = run(flow, {"ModelGen.train_en": False})

The JAX package's ``core/strategies.py`` for the O-tasks the port has:
:data:`O_TASKS` holds TUNE (``"T"``) and SERVE (``"V"``); PRUNING,
SCALING, QUANTIZATION and SHARDING-SEARCH join with their slices.
"""

from __future__ import annotations

from typing import Any

from repro_torch.core.flow import DesignFlow
from repro_torch.core.metamodel import MetaModel
from repro_torch.tasks.model_gen import ModelGen
from repro_torch.tasks.serve import Serve
from repro_torch.tasks.tune import Tune

O_TASKS = {"T": Tune, "V": Serve}


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


def combined_strategy(model: str = "jet_dnn", order: str = "T",
                      task_params: dict[str, dict] | None = None,
                      model_params: dict | None = None) -> DesignFlow:
    """Combined cross-stage strategy with O-tasks in ``order`` (one
    character per task, :data:`O_TASKS`).  Reordering is a one-char edit
    — the customizability claim of the paper."""
    task_params = task_params or {}
    unknown = sorted(set(order) - set(O_TASKS))
    if unknown:
        raise NotImplementedError(
            f"O-tasks {unknown} are not ported yet (have {sorted(O_TASKS)}; "
            f"ROADMAP Queue 1)")
    flow = DesignFlow(f"{'+'.join(order)}({model})")
    tasks: list[Any] = [ModelGen(model=model, **(model_params or {}))]
    for ch in order:
        tasks.append(O_TASKS[ch](**task_params.get(ch, {})))
    flow.chain(*tasks)
    return flow


def run(flow: DesignFlow, cfg: dict | None = None) -> MetaModel:
    return flow.execute(MetaModel(cfg))
