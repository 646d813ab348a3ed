"""SCALING O-task (paper §V-B, Table I).

"To accommodate a large DNN design on an FPGA, our framework supports the
SCALING O-task which automatically reduces the layer size while tracking
the accuracy loss (alpha_s).  The search stops when the loss exceeds
alpha_s."

With ``scale_auto`` the task walks a geometric ladder of width factors
(1/sqrt(2) steps by default), retraining at each width, and keeps the last
feasible one; with ``scale_auto=False`` it applies ``default_scale_factor``
once.  For LM handles scaling shrinks d_ff (and d_expert for MoE) — the
dominant-width analogue.  The port of the JAX package's
``tasks/scaling.py``: each width re-initialises from a ``torch.Generator``
on the handle's device seeded ``seed + int(scale * 1e4)``, where the JAX
package seeds its ``PRNGKey``.
"""

from __future__ import annotations

import torch

from repro_torch.core.metamodel import LEVEL_DNN, MetaModel
from repro_torch.core.search import monotone_shrink_search
from repro_torch.core.task import OTask
from repro_torch.data.synthetic import lm_tokens
from repro_torch.models.api import build_model
from repro_torch.models.cnn import BENCH_MODELS
from repro_torch.tasks.handle import DNNHandle
from repro_torch.tasks.train_utils import lm_finetune, train_classifier


class Scaling(OTask):
    n_in = 1
    n_out = 1
    defaults = {
        "default_scale_factor": 0.5,
        "tolerate_acc_loss": 0.0005,   # alpha_s (paper: 0.05%)
        "scale_auto": True,
        "max_trials_num": 4,
        "train_epochs": 3,
        "lr": 3e-3,
        "seed": 0,
    }

    def execute(self, meta: MetaModel, inputs):
        art = meta.model(inputs[0])
        handle: DNNHandle = art.payload
        alpha = self.param(meta, "tolerate_acc_loss")
        base_acc = art.metrics.get("accuracy") or handle.evaluate()

        if self.param(meta, "scale_auto"):
            ladder = []
            s = handle.scale
            for _ in range(self.param(meta, "max_trials_num")):
                s = s / (2 ** 0.5)
                ladder.append(round(s, 4))
        else:
            ladder = [handle.scale
                      * self.param(meta, "default_scale_factor")]

        best: dict = {}

        def feasible(scale: float):
            probe = self._rebuild_at_scale(meta, handle, scale)
            acc = probe.evaluate()
            ok = (base_acc - acc) <= alpha
            meta.record("scaling.probe", scale=scale, accuracy=acc,
                        feasible=ok, **probe.resource_metrics())
            if ok:
                best.update(scale=scale, handle=probe, acc=acc)
            return ok, -scale, {"accuracy": acc}

        result = monotone_shrink_search(
            ladder, feasible, max_trials=self.param(meta, "max_trials_num"))
        if "handle" not in best:
            best.update(scale=handle.scale, handle=handle, acc=base_acc)
        out_handle = best["handle"]
        metrics = {"accuracy": best["acc"], "base_accuracy": base_acc,
                   "scale": best["scale"], "search_steps": result.n_steps,
                   **out_handle.summary_metrics()}
        out = meta.add_model(f"{handle.name}+S", LEVEL_DNN, out_handle,
                             parent=inputs[0], metrics=metrics)
        meta.record("scaling.done", scale=best["scale"],
                    accuracy=best["acc"])
        meta.set("scaling.result", metrics)
        return [out]

    def _rebuild_at_scale(self, meta, handle: DNNHandle,
                          scale: float) -> DNNHandle:
        seed = self.param(meta, "seed")
        init_seed = seed + int(scale * 1e4)
        if handle.kind == "bench":
            init_fn, apply_fn, _ = BENCH_MODELS[handle.name.split("+")[0]]
            gen = torch.Generator(device=handle.device())
            gen.manual_seed(init_seed)
            params = init_fn(gen, scale=scale)
            params, _ = train_classifier(
                params, apply_fn, handle.train_data,
                epochs=self.param(meta, "train_epochs"),
                lr=self.param(meta, "lr"), policy=handle.policy, seed=seed)
            # masks no longer shape-compatible after scaling
            return handle.child(params=params, scale=scale, masks=None)
        # LM: shrink ffn widths, re-init, brief train
        cfg = handle.model.cfg
        rel = scale / handle.scale
        new_cfg = cfg.replace(
            d_ff=max(64, int(cfg.d_ff * rel) // 64 * 64) if cfg.d_ff else 0,
            d_expert=max(64, int(cfg.d_expert * rel) // 64 * 64)
            if cfg.d_expert else 0)
        model = build_model(new_cfg, policy=handle.policy,
                            device=handle.model.device)
        params = model.init(init_seed)

        def batches(s):
            t = lm_tokens(4 * 64 + 1, new_cfg.vocab_size, seed=200 + s)
            return {"tokens": t[:-1].reshape(4, 64),
                    "labels": t[1:].reshape(4, 64)}

        params, _ = lm_finetune(model, params, batches,
                                steps=self.param(meta, "train_epochs") * 4)
        return handle.child(params=params, model=model, scale=scale,
                            masks=None)
