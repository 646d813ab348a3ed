"""PRUNING O-task (paper §V-B, Table I).

    maximize   pruning_rate
    subject to accuracy_loss(pruning_rate) <= tolerate_acc_loss (alpha_p)

Auto-pruning binary search over the rate, terminating when the bracket is
below ``pruning_rate_thresh`` (beta_p) — `1 + log2(1/beta_p)` probes.  Each
probe builds magnitude masks at the candidate rate, fine-tunes briefly with
the masks projected after every update (gradually ramped), and evaluates
accuracy.  The feasible candidate with the highest rate is selected (paper
Fig. 3/4); its masks and fine-tuned weights form the output artifact.

The port of the JAX package's ``tasks/pruning.py``, probe for probe.  The
default granularity is 128x128 blocks on weights that span several tiles,
so zero blocks are structurally skippable by the block-sparse kernel
(``kernels/block_sparse_matmul.py``); ``granularity="unstructured"``
reproduces the paper's curves exactly.  A probe's fine-tune runs where the
handle's parameters live, under the handle's policy (bench models; an LM
fine-tunes under its model's policy, as in the JAX package).
"""

from __future__ import annotations

from repro_torch.core.metamodel import LEVEL_DNN, MetaModel
from repro_torch.core.search import binary_search_max
from repro_torch.core.task import OTask
from repro_torch.data.synthetic import lm_tokens
from repro_torch.sparsity.masks import (build_masks, flatten_params,
                                        polynomial_schedule, prunable_paths)
from repro_torch.tasks.handle import DNNHandle
from repro_torch.tasks.train_utils import lm_finetune, train_classifier


class Pruning(OTask):
    n_in = 1
    n_out = 1
    defaults = {
        "tolerate_acc_loss": 0.02,     # alpha_p
        "pruning_rate_thresh": 0.02,   # beta_p
        "train_epochs": 2,
        "granularity": "auto",         # auto | block | unstructured
        "block": 128,
        "max_rate": 1.0,
        "lr": 1e-3,
    }

    def execute(self, meta: MetaModel, inputs):
        art = meta.model(inputs[0])
        handle: DNNHandle = art.payload
        alpha = self.param(meta, "tolerate_acc_loss")
        beta = self.param(meta, "pruning_rate_thresh")
        gran = self.param(meta, "granularity")
        block = self.param(meta, "block")
        epochs = self.param(meta, "train_epochs")

        base_acc = art.metrics.get("accuracy")
        if base_acc is None:
            base_acc = handle.evaluate()
        paths = prunable_paths(handle.params, min_size=64)
        if gran == "auto":
            # block granularity is only meaningful when weights span
            # multiple tiles; small bench nets prune unstructured
            # (paper-faithful), large LM mats prune at tile granularity.
            flat = flatten_params(handle.params)
            biggest = max((max(flat[p].shape) for p in paths), default=0)
            gran = "block" if biggest >= 4 * block else "unstructured"
            meta.record("pruning.granularity", chosen=gran)
        best: dict = {}

        def feasible(rate: float):
            if rate <= 0.0:
                acc = base_acc
                meta.record("pruning.probe", rate=0.0, accuracy=acc)
                return True, 0.0, {"accuracy": acc}
            trained, masks = self._finetune_at_rate(
                handle, rate, paths, gran, block, epochs)
            probe = handle.child(params=trained, masks=masks)
            acc = probe.evaluate()
            ok = (base_acc - acc) <= alpha
            meta.record("pruning.probe", rate=rate, accuracy=acc,
                        feasible=ok, **probe.resource_metrics())
            if ok and rate >= best.get("rate", -1.0):
                best.update(rate=rate, handle=probe, acc=acc)
            return ok, rate, {"accuracy": acc}

        result = binary_search_max(feasible, lo=0.0,
                                   hi=self.param(meta, "max_rate"),
                                   beta=beta)
        if "handle" not in best:   # nothing feasible beyond 0%
            best.update(rate=0.0, handle=handle, acc=base_acc)
        out_handle = best["handle"]
        metrics = {"accuracy": best["acc"], "base_accuracy": base_acc,
                   "pruning_rate": best["rate"],
                   "search_steps": result.n_steps,
                   **out_handle.summary_metrics()}
        out = meta.add_model(f"{handle.name}+P", LEVEL_DNN, out_handle,
                             parent=inputs[0], metrics=metrics)
        meta.record("pruning.done", rate=best["rate"], accuracy=best["acc"],
                    steps=result.n_steps)
        meta.set("pruning.result", metrics)
        return [out]

    def _finetune_at_rate(self, handle: DNNHandle, rate, paths, gran,
                          block, epochs):
        lr = self.params.get("lr", type(self).defaults["lr"])
        if handle.kind == "bench":
            n = len(handle.train_data[0])
            steps_total = max(1, epochs * max(1, n // 128))
            ramp_end = max(1, steps_total // 2)

            # the ramp's masks come from the input handle's weights, not
            # the weights being fine-tuned, as in the JAX package
            def mask_schedule(step):
                r = polynomial_schedule(step, 0, ramp_end, rate)
                return build_masks(handle.params, r, gran, paths, block)

            final_masks = build_masks(handle.params, rate, gran, paths,
                                      block)
            trained, _ = train_classifier(
                handle.params, handle.apply_fn, handle.train_data,
                epochs=epochs, lr=lr, policy=handle.policy,
                mask_schedule=lambda s: (mask_schedule(s)
                                         if s < ramp_end else final_masks))
            return trained, final_masks
        # LM: direct masks + brief fine-tune
        masks = build_masks(handle.params, rate, gran, paths, block)
        cfg = handle.model.cfg

        def batches(s):
            t = lm_tokens(4 * 64 + 1, cfg.vocab_size, seed=100 + s)
            return {"tokens": t[:-1].reshape(4, 64),
                    "labels": t[1:].reshape(4, 64)}

        trained, _ = lm_finetune(handle.model, handle.params, batches,
                                 steps=epochs * 4, masks=masks)
        return trained, masks
