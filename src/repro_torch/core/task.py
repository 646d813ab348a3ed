"""Pipe tasks: the basic unit of a MetaML design flow.

Paper §III/§IV: "The pipe task serves as the basic unit of the design flow,
executing specific optimizations or transformations."  Two kinds:

- O-task: self-contained optimization task that enhances a given model based
  on specific objectives and constraints (PRUNING, SCALING, QUANTIZATION,
  TUNE, ...).
- λ-task: functional transformation on the model space (model generation,
  lowering, compilation — the analogues of HLS4ML / Vivado HLS).

Each task declares a *multiplicity* (paper Table I): how many input and output
model connections it handles, e.g. ``KERAS-MODEL-GEN`` is 0-to-1, all O-tasks
are 1-to-1.
"""

from __future__ import annotations

import time
from typing import Any

from repro_torch.core.metamodel import MetaModel

O_TASK = "O"
LAMBDA_TASK = "λ"


class TaskError(RuntimeError):
    pass


class PipeTask:
    """Base class for design-flow tasks.

    Subclasses set ``kind`` (O_TASK / LAMBDA_TASK), ``n_in``/``n_out``
    (multiplicity) and ``defaults`` (parameter defaults, overridable per
    instance and via the meta-model CFG: CFG key ``f"{name}.{param}"`` wins
    over the instance param, which wins over the class default — this is what
    the paper means by the CFG "holding the parameters of all pipe tasks").
    """

    kind: str = LAMBDA_TASK
    n_in: int = 1
    n_out: int = 1
    defaults: dict[str, Any] = {}

    def __init__(self, name: str | None = None, **params: Any):
        self.name = name or type(self).__name__
        unknown = set(params) - set(type(self).defaults)
        if unknown:
            raise TaskError(f"{self.name}: unknown parameters {sorted(unknown)}")
        self.params = dict(params)

    # ------------------------------------------------------------ config
    def param(self, meta: MetaModel, key: str) -> Any:
        cfg_key = f"{self.name}.{key}"
        if cfg_key in meta.cfg:
            return meta.cfg[cfg_key]
        if key in self.params:
            return self.params[key]
        if key in type(self).defaults:
            return type(self).defaults[key]
        raise TaskError(f"{self.name}: missing parameter {key!r}")

    def all_params(self, meta: MetaModel) -> dict[str, Any]:
        return {k: self.param(meta, k) for k in type(self).defaults}

    # --------------------------------------------------------------- run
    def run(self, meta: MetaModel, inputs: list[str]) -> list[str]:
        """Execute the task.  ``inputs``/outputs are model-space names."""
        if len(inputs) != self.n_in:
            raise TaskError(
                f"{self.name}: expected {self.n_in} input model(s), got "
                f"{len(inputs)} (multiplicity {self.n_in}-to-{self.n_out})")
        t0 = time.time()
        meta.record("task.start", task=self.name, kind=self.kind,
                    inputs=list(inputs), params=self.all_params(meta))
        try:
            outputs = self.execute(meta, inputs)
        except Exception as e:  # noqa: BLE001 — re-raise after logging
            meta.record("task.error", task=self.name, error=repr(e))
            raise
        if len(outputs) != self.n_out:
            raise TaskError(
                f"{self.name}: produced {len(outputs)} outputs, declared "
                f"{self.n_out}")
        meta.record("task.done", task=self.name, outputs=list(outputs),
                    seconds=time.time() - t0)
        return outputs

    def execute(self, meta: MetaModel, inputs: list[str]) -> list[str]:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"<{self.kind}-task {self.name} {self.n_in}-to-{self.n_out}>"


class OTask(PipeTask):
    kind = O_TASK


class LambdaTask(PipeTask):
    kind = LAMBDA_TASK
