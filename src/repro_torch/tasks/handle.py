"""DNN-level artifact payloads + resource metrics (DSP/LUT analogues).

A :class:`DNNHandle` is what lives in the meta-model's model space at
LEVEL_DNN — a model together with everything the O-tasks mutate:
pruning masks, the quantization policy, and the SCALING width factor.
The port's form of the JAX package's ``tasks/handle.py``: bench-model
parameters are nested dicts of tensors, an LM's are its module, seen by
path through ``sparsity/masks.py::flatten_params`` exactly as the JAX
pytree of the same model.

Resource proxies:
- ``effective_macs``: multiply-accumulates per sample surviving pruning &
  scaling — the analogue of DSP usage on a fully-unrolled FPGA design.
- ``weight_bits``: total weight storage bits under the quantization policy
  — the analogue of LUT/BRAM usage.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models.common import Ctx
from repro_torch.quant.policy import LEVEL_BYTES, PrecisionPolicy
from repro_torch.sparsity.masks import apply_masks, flatten_params


@dataclasses.dataclass
class DNNHandle:
    kind: str                       # "bench" | "lm"
    name: str
    params: Any
    apply_fn: Callable | None = None   # bench: (ctx, params, x) -> logits
    model: Any = None                  # lm: repro_torch.models.api.LMModel
    meta: dict = dataclasses.field(default_factory=dict)
    scale: float = 1.0
    masks: dict | None = None
    policy: PrecisionPolicy | None = None
    train_data: tuple | None = None    # (x, y) or token batch dict
    test_data: tuple | None = None

    # ----------------------------------------------------------- compute
    def ctx(self) -> Ctx:
        return Ctx(policy=self.policy)

    def device(self) -> torch.device:
        """Where the parameters live (an LM's model device)."""
        if self.model is not None:
            return self.model.device
        return next(t.device for t in flatten_params(self.params).values())

    def effective_params(self):
        p = self.params
        if self.masks:
            p = apply_masks(p, self.masks)
        return p

    def logits(self, x):
        return self.apply_fn(self.ctx(), self.effective_params(), x)

    # ---------------------------------------------------------- accuracy
    @torch.no_grad()
    def evaluate(self, data=None, batch: int = 512) -> float:
        """Classification accuracy (bench) / next-token top-1 (lm)."""
        data = data if data is not None else self.test_data
        dev = self.device()
        if self.kind == "bench":
            x, y = data
            params = self.effective_params()
            correct = 0
            for i in range(0, len(x), batch):
                out = self.apply_fn(self.ctx(), params,
                                    torch.from_numpy(x[i:i + batch]).to(dev))
                want = torch.from_numpy(np.asarray(y[i:i + batch])).to(dev)
                correct += int((out.argmax(-1) == want).sum())
            return correct / len(x)
        # lm: data is {"tokens","labels"}
        m = self.model
        m2 = dataclasses.replace(m, policy=self.policy) \
            if self.policy is not None else m
        from repro_torch.models import transformer as T
        tokens = torch.from_numpy(np.asarray(data["tokens"])).long().to(dev)
        logits, _ = T.lm_apply(m2.ctx(), m2.cfg, self.effective_params(),
                               tokens)
        labels = torch.from_numpy(np.asarray(data["labels"])).to(dev)
        return float((logits.argmax(-1) == labels).float().mean())

    # ---------------------------------------------------- resource proxy
    def resource_metrics(self) -> dict[str, float]:
        flat = flatten_params(self.params)
        policy = self.policy or PrecisionPolicy()
        total_macs = 0.0
        alive_macs = 0.0
        weight_bits = 0.0
        spatial = self.meta.get("conv_spatial", {})
        for path, w in flat.items():
            if w.ndim < 2:
                continue
            n = float(np.prod(w.shape))
            # conv kernels act at every spatial position
            mult = float(spatial.get(path.split("/")[0], 1.0)) \
                if w.ndim == 4 else 1.0
            total_macs += n * mult
            if self.masks and path in self.masks:
                alive = float(torch.count_nonzero(self.masks[path]))
            else:
                alive = n
            alive_macs += alive * mult
            level = policy.level_for(path)
            weight_bits += alive * LEVEL_BYTES[level] * 8
        return {
            "total_macs": total_macs,
            "effective_macs": alive_macs,
            "macs_fraction": alive_macs / max(1.0, total_macs),
            "weight_bits": weight_bits,
            "weight_mbytes": weight_bits / 8 / 1e6,
        }

    def summary_metrics(self) -> dict[str, float]:
        out = self.resource_metrics()
        out["scale"] = self.scale
        if self.masks:
            from repro_torch.sparsity.masks import sparsity_report
            out.update(sparsity_report(self.masks))
        return out

    def child(self, **overrides) -> "DNNHandle":
        return dataclasses.replace(self, **overrides)
