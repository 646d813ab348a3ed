"""QUANTIZATION O-task (paper §V-B, Table I).

Paper: operates at the HLS C++ level via source-to-source transformation;
per-layer mixed precision accepted while accuracy loss < alpha_q, repeated
until no further move helps.

As in the JAX package's ``tasks/quantization.py``: the precision lattice is
{fp32 > bf16 > fp8 > int8}; the per-layer policy is injected into every
``linear`` call (``models/common.py``) — INT8 layers run the quant_matmul
kernel — the analogue of instrumenting the generated C++ kernel.  The
greedy descent walks each layer down the lattice, keeping moves whose
accuracy loss stays within alpha_q.
"""

from __future__ import annotations

from repro_torch.core.metamodel import LEVEL_DNN, MetaModel
from repro_torch.core.search import greedy_lattice_descent
from repro_torch.core.task import OTask
from repro_torch.quant.policy import BF16, FP8, INT8, LEVELS, PrecisionPolicy
from repro_torch.sparsity.masks import flatten_params
from repro_torch.tasks.handle import DNNHandle


def quantizable_groups(handle: DNNHandle) -> list[str]:
    """Layer-name patterns the policy can move down the lattice."""
    if handle.kind == "bench":
        flat = flatten_params(handle.params)
        groups = sorted({p.split("/")[0] for p in flat})
        return [g for g in groups if not g.startswith(("bn", "norm"))]
    # lm: one group per linear site inside the block (policy patterns)
    cfg = handle.model.cfg
    groups = ["lm_head"]
    if cfg.use_mla:
        groups += ["attn/wq_b", "attn/wkv_a", "attn/wkv_b", "attn/wo"]
    elif cfg.family not in ("ssm",):
        groups += ["attn/wq", "attn/wk", "attn/wv", "attn/wo"]
    if cfg.is_moe:
        groups += ["moe/experts", "mlp/*"]
    elif cfg.d_ff:
        groups += ["mlp/*"]
    if cfg.family == "ssm":
        groups += ["mlstm/*", "slstm/w_in", "slstm/w_out", "slstm/*ff*"]
    if cfg.family == "hybrid":
        groups += ["ssm/in_proj", "ssm/out_proj", "attn/*", "mlp/*"]
    return groups


class Quantization(OTask):
    n_in = 1
    n_out = 1
    defaults = {
        "tolerate_acc_loss": 0.01,    # alpha_q
        "start_level": BF16,
        "levels": (BF16, FP8, INT8),
        "passes": 2,
    }

    def execute(self, meta: MetaModel, inputs):
        art = meta.model(inputs[0])
        handle: DNNHandle = art.payload
        alpha = self.param(meta, "tolerate_acc_loss")
        levels = list(self.param(meta, "levels"))
        start = self.param(meta, "start_level")
        assert all(lv in LEVELS for lv in levels)
        base_acc = art.metrics.get("accuracy") or handle.evaluate()
        base_policy = handle.policy or PrecisionPolicy()
        groups = quantizable_groups(handle)

        state: dict = {"best": None}

        def accept(assignment: dict[str, str]):
            policy = PrecisionPolicy(default=base_policy.default,
                                     exempt=base_policy.exempt)
            for pat, lv in assignment.items():
                policy = policy.with_rule(f"*{pat}*", lv)
            probe = handle.child(policy=policy)
            acc = probe.evaluate()
            ok = (base_acc - acc) < alpha
            meta.record("quantization.probe",
                        assignment={k: str(v) for k, v in
                                    assignment.items()},
                        accuracy=acc, feasible=ok,
                        weight_bits=probe.resource_metrics()["weight_bits"])
            if ok:
                state["best"] = (probe, acc, assignment)
            return ok, acc, {"accuracy": acc}

        assignment, result = greedy_lattice_descent(
            groups, levels, accept, start_level=start,
            passes=self.param(meta, "passes"))

        if state["best"] is None:
            probe, acc = handle, base_acc
            assignment = {g: start for g in groups}
        else:
            probe, acc, assignment = state["best"]
        metrics = {"accuracy": acc, "base_accuracy": base_acc,
                   "assignment": {k: str(v) for k, v in assignment.items()},
                   "search_steps": result.n_steps,
                   **probe.summary_metrics()}
        out = meta.add_model(f"{handle.name}+Q", LEVEL_DNN, probe,
                             parent=inputs[0], metrics=metrics)
        meta.record("quantization.done", accuracy=acc,
                    weight_bits=metrics["weight_bits"])
        meta.set("quantization.result", metrics)
        return [out]
