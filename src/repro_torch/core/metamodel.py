"""Meta-model: the shared state of a MetaML design flow.

Paper §III: "The meta-model ... serves as a shared space for storing the states
of the design flow. This model consists of three sections: configuration, log,
and model space."

- CFG    : key-value store holding the parameters of all pipe tasks.
- LOG    : runtime execution trace (used for debugging and for the
           EXPERIMENTS.md iteration logs).
- models : the model space — every artifact generated during flow execution,
           at any abstraction level, together with its reports and
           computed metrics.

The port's copy of the JAX package's ``core/metamodel.py``: the same
CFG / LOG / model-space contract, so a flow reads the same in both.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Iterator


# Abstraction levels an artifact can live at.  These mirror the paper's
# DNN / HLS C++ / RTL levels; the port has tasks at the DNN level so far,
# and keeps the other two names so that artifacts are labelled as in the
# JAX package.
LEVEL_DNN = "dnn"            # a model (parameters + apply fn)
LEVEL_LOWERED = "lowered"    # a lowered artifact (not produced by the port yet)
LEVEL_COMPILED = "compiled"  # a compiled artifact (not produced by the port yet)


@dataclasses.dataclass
class ModelArtifact:
    """One entry in the model space.

    ``payload`` is level-dependent; at LEVEL_DNN it is a
    :class:`repro_torch.tasks.handle.DNNHandle`.
    ``metrics`` holds computed numbers (accuracy, roofline terms, resource
    proxies...); ``reports`` holds larger textual reports (HLO excerpts,
    memory analyses) — the analogue of the paper's "supporting files and tool
    reports".
    """

    name: str
    level: str
    payload: Any
    parent: str | None = None
    metrics: dict[str, Any] = dataclasses.field(default_factory=dict)
    reports: dict[str, str] = dataclasses.field(default_factory=dict)
    created_at: float = dataclasses.field(default_factory=time.time)

    def summary(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "level": self.level,
            "parent": self.parent,
            "metrics": {k: v for k, v in self.metrics.items()
                        if isinstance(v, (int, float, str, bool))},
        }


class MetaModel:
    """Shared state for a design flow (CFG / LOG / model space)."""

    def __init__(self, cfg: dict[str, Any] | None = None):
        self.cfg: dict[str, Any] = dict(cfg or {})
        self.log: list[dict[str, Any]] = []
        self._models: dict[str, ModelArtifact] = {}
        self._counter = 0

    # ---------------------------------------------------------------- CFG
    def get(self, key: str, default: Any = None) -> Any:
        return self.cfg.get(key, default)

    def set(self, key: str, value: Any) -> None:
        self.cfg[key] = value

    def update(self, values: dict[str, Any]) -> None:
        self.cfg.update(values)

    # ---------------------------------------------------------------- LOG
    def record(self, event: str, **fields: Any) -> None:
        entry = {"t": time.time(), "event": event, **fields}
        self.log.append(entry)

    def trace(self, event_prefix: str = "") -> list[dict[str, Any]]:
        return [e for e in self.log if e["event"].startswith(event_prefix)]

    def dump_log(self, path: str) -> None:
        with open(path, "w") as f:
            for entry in self.log:
                f.write(json.dumps(entry, default=str) + "\n")

    # -------------------------------------------------------- model space
    def fresh_name(self, stem: str) -> str:
        self._counter += 1
        return f"{stem}#{self._counter}"

    def put(self, artifact: ModelArtifact) -> str:
        self._models[artifact.name] = artifact
        self.record("model_space.put", name=artifact.name,
                    level=artifact.level, parent=artifact.parent)
        return artifact.name

    def add_model(self, stem: str, level: str, payload: Any,
                  parent: str | None = None,
                  metrics: dict[str, Any] | None = None,
                  reports: dict[str, str] | None = None) -> str:
        art = ModelArtifact(name=self.fresh_name(stem), level=level,
                            payload=payload, parent=parent,
                            metrics=dict(metrics or {}),
                            reports=dict(reports or {}))
        return self.put(art)

    def model(self, name: str) -> ModelArtifact:
        return self._models[name]

    def __contains__(self, name: str) -> bool:
        return name in self._models

    def models(self, level: str | None = None) -> Iterator[ModelArtifact]:
        for art in self._models.values():
            if level is None or art.level == level:
                yield art

    def latest(self, level: str | None = None,
               pred: Callable[[ModelArtifact], bool] | None = None
               ) -> ModelArtifact | None:
        best = None
        for art in self.models(level):
            if pred is not None and not pred(art):
                continue
            if best is None or art.created_at >= best.created_at:
                best = art
        return best

    def lineage(self, name: str) -> list[str]:
        """Chain of parents from ``name`` back to the root artifact."""
        chain = [name]
        while self._models[chain[-1]].parent is not None:
            chain.append(self._models[chain[-1]].parent)
        return chain

    def space_summary(self) -> list[dict[str, Any]]:
        return [a.summary() for a in self._models.values()]
