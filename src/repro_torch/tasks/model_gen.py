"""MODEL-GEN λ-task (paper Table I: KERAS-MODEL-GEN, multiplicity 0-to-1).

Builds a model (bench CNN/MLP or LM arch), optionally trains it on the
configured dataset, and places the DNN-level artifact into the model
space with baseline accuracy + resource metrics, as the JAX package's
``tasks/model_gen.py`` does.  Parameters are drawn from a
``torch.Generator`` seeded with ``seed`` on the task's ``device`` (CUDA
unless the caller passes ``device="cpu"``).  With ``train_en`` a bench
model trains with ``train_classifier`` and an LM arch fine-tunes with
``lm_finetune`` on the JAX package's synthetic token batches.  With
``device="meta"`` an LM arch's model is built on the ``meta`` device and
neither trained nor evaluated: the dry-run flow's MODEL-GEN, which needs
only its shapes.
"""

from __future__ import annotations

import torch

from repro_torch.core.metamodel import LEVEL_DNN, MetaModel
from repro_torch.core.task import LambdaTask
from repro_torch.data import synthetic
from repro_torch.models.api import DEFAULT_EXEMPT, build_model
from repro_torch.models.cnn import BENCH_MODELS
from repro_torch.models.common import resolve_device
from repro_torch.quant.policy import FP32, PrecisionPolicy
from repro_torch.tasks.handle import DNNHandle
from repro_torch.tasks.train_utils import lm_finetune, train_classifier

BENCH_DATASETS = {"jet_dnn": "jet", "vgg7": "mnist_like",
                  "resnet9": "svhn_like"}


class ModelGen(LambdaTask):
    n_in = 0
    n_out = 1
    defaults = {
        "model": "jet_dnn",         # bench name or LM arch id
        "train_en": True,
        "train_epochs": 5,
        "train_samples": 3072,
        "batch": 128,
        "lr": 3e-3,
        "seed": 0,
        "smoke": False,             # LM archs: reduced config
        "scale": 1.0,
        "device": None,             # None -> cuda; "cpu" runs plain versions
    }

    def execute(self, meta: MetaModel, inputs):
        name = self.param(meta, "model")
        seed = self.param(meta, "seed")
        device = resolve_device(self.param(meta, "device"))
        gen = None
        if device.type != "meta":
            gen = torch.Generator(device=device)
            gen.manual_seed(int(seed))
        if device.type == "meta":         # the dry run's: shapes only
            handle = self._abstract_lm(meta, name)
            acc = None
        elif name in BENCH_MODELS:
            handle = self._build_bench(meta, name, gen)
            acc = handle.evaluate()
        else:
            handle = self._build_lm(meta, name, device)
            acc = handle.evaluate()
        metrics = {"accuracy": acc, **handle.summary_metrics()}
        out = meta.add_model(name, LEVEL_DNN, handle, metrics=metrics)
        meta.record("model_gen", model=name, accuracy=acc)
        return [out]

    def _build_bench(self, meta, name, gen) -> DNNHandle:
        init_fn, apply_fn, info = BENCH_MODELS[name]
        scale = self.param(meta, "scale")
        params = init_fn(gen, scale=scale)
        ds_fn = synthetic.DATASETS[BENCH_DATASETS[name]]
        n = self.param(meta, "train_samples")
        x, y = ds_fn(n, seed=self.param(meta, "seed"))
        (xtr, ytr), (xte, yte) = synthetic.train_test_split(x, y)
        handle = DNNHandle(
            kind="bench", name=name, params=params, apply_fn=apply_fn,
            meta=dict(info), scale=scale,
            policy=PrecisionPolicy(default=FP32, exempt=DEFAULT_EXEMPT),
            train_data=(xtr, ytr), test_data=(xte, yte))
        if self.param(meta, "train_en"):
            params, losses = train_classifier(
                params, apply_fn, (xtr, ytr),
                epochs=self.param(meta, "train_epochs"),
                batch=self.param(meta, "batch"),
                lr=self.param(meta, "lr"),
                seed=self.param(meta, "seed"))
            handle = handle.child(params=params)
            meta.record("model_gen.train", model=name,
                        final_loss=losses[-1] if losses else None)
        return handle

    def _abstract_lm(self, meta, arch) -> DNNHandle:
        """``device="meta"``: an LM arch's model on the ``meta`` device —
        no allocation, no training, no evaluation (the dry-run flow reads
        its config; ``core/strategies.py::dryrun_flow``)."""
        from repro_torch.configs.registry import get_config
        model = build_model(get_config(arch, smoke=self.param(meta, "smoke")),
                            device="meta")
        return DNNHandle(kind="lm", name=arch,
                         params=model.abstract_params(), model=model,
                         policy=model.policy)

    def _build_lm(self, meta, arch, device) -> DNNHandle:
        from repro_torch.configs.registry import get_config
        cfg = get_config(arch, smoke=self.param(meta, "smoke"))
        model = build_model(cfg, device=device)
        params = model.init(self.param(meta, "seed"))
        # synthetic eval batch for next-token accuracy
        toks = synthetic.lm_tokens(8 * 128 + 1, cfg.vocab_size,
                                   seed=self.param(meta, "seed"))
        data = {"tokens": toks[:-1].reshape(8, 128),
                "labels": toks[1:].reshape(8, 128)}
        handle = DNNHandle(kind="lm", name=arch, params=params, model=model,
                           policy=model.policy, test_data=data,
                           train_data=data)
        if self.param(meta, "train_en"):
            def batches(s):
                t = synthetic.lm_tokens(4 * 64 + 1, cfg.vocab_size, seed=s)
                return {"tokens": t[:-1].reshape(4, 64),
                        "labels": t[1:].reshape(4, 64)}

            params, _ = lm_finetune(model, params, batches,
                                    steps=self.param(meta, "train_epochs"))
            handle = handle.child(params=params)
        return handle
