"""The PyTorch port stands alone: every module imports without JAX or the
JAX package, its sources name neither, and its entry points refuse to run
on a missing CUDA device instead of dropping to the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"

IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes")
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
assert "repro_torch.models.ssm" in names
assert "repro_torch.launch.whisper_serve" in names
assert "repro_torch.runtime.train_loop" in names
assert "repro_torch.launch.train" in names
print(len(names))
"""


def test_every_module_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", IMPORT_ALL], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    # configs, models, serving, ... and the design flow: core, sparsity,
    # tasks, models.cnn, kernels.{autotune,ops,ref} and the two kernels;
    # then serving.{cluster,journal,traffic} and tasks.serve; then optim,
    # optim.optimizers and tasks.{train_utils,pruning,scaling,quantization};
    # then models.ssm; then launch.whisper_serve; then the trainer:
    # checkpoint{,.manager}, data.pipeline, launch.train,
    # optim.compression and runtime{,.train_loop}
    assert int(r.stdout.strip()) >= 80


# the last two: atomic floating-point scatters, whose sums change order
# from run to run on the card (greedy tokens must be bit-reproducible)
@pytest.mark.parametrize("needle", [
    "import jax", "from repro.", "import repro.", "ml_dtypes",
    "scaled_dot_product_attention", "torch.compile", "_int_mm",
    "index_add_", "scatter_add_"])
def test_sources_name_no_jax_or_library_kernel(needle):
    scanned = [f for f in sorted(PORT.rglob("*"))
               if f.suffix in (".py", ".cu", ".cuh")]
    assert PORT / "models" / "ssm.py" in scanned
    assert PORT / "launch" / "whisper_serve.py" in scanned
    hits = [str(f.relative_to(SRC)) for f in scanned
            if needle in f.read_text()]
    assert not hits, hits


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving import PagedCacheConfig, init_paged_cache
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2_7b", smoke=True)
    pcfg = PagedCacheConfig(page_size=8, n_pages=5, max_slots=2,
                            max_blocks=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_paged_cache(cfg, pcfg)
    from repro_torch.core.metamodel import MetaModel
    from repro_torch.core.strategies import pruning_strategy
    with pytest.raises(RuntimeError, match="CUDA"):
        pruning_strategy("jet_dnn").execute(MetaModel())
    import dataclasses
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.train import main as train_main
    from repro_torch.runtime.train_loop import train_loop
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(["--arch", "qwen2_7b", "--smoke", "--steps", "1"])
    cuda_model = dataclasses.replace(build_model(cfg, device="cpu"),
                                     device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="CUDA"):
        train_loop(cuda_model, steps=1, batcher=None,
                   ckpt=CheckpointManager(str(tmp_path)))
    assert os.listdir(tmp_path) == []      # nothing written
    model = build_model(cfg, device="cpu")
    assert model.device.type == "cpu"
    cache = init_paged_cache(cfg, pcfg, device="cpu")
    assert cache["blocks"]["k_pages"].shape == (2, 5, 8, 1, 8)


def test_unported_paths_raise_not_implemented():
    """Nothing on these paths is refused any more: every registry config
    builds through ``build_model`` (the encoder-decoder family too), and
    the serial admission path, the INT8/FP8 levels and the write-ahead
    journal (a durable plan) are ported and run."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    from repro_torch.models.common import Ctx, linear
    from repro_torch.quant.policy import PrecisionPolicy
    from repro_torch.serving import (DurabilityPolicy, PagedCacheConfig,
                                     PagedServingEngine, ServingPlan)
    cfg = get_config("qwen2_7b", smoke=True)
    model = build_model(cfg, device="cpu")
    pcfg = PagedCacheConfig(page_size=8, n_pages=5, max_slots=2,
                            max_blocks=2)
    eng = PagedServingEngine(model, pcfg, prefill_mode="serial")
    assert eng.prefill_mode == "serial" and not eng.sharing
    plan = ServingPlan(cache=pcfg, durability=DurabilityPolicy(
        enabled=True, journal_dir="/nonexistent"))
    durable = PagedServingEngine.from_plan(model, plan)
    assert durable.plan.durability.enabled and durable.pcfg == pcfg
    x, w = torch.ones((1, 4)), torch.ones((4, 2))
    for level in ("int8", "fp8"):
        y = linear(Ctx(policy=PrecisionPolicy(default=level)), "m", x, w)
        assert torch.equal(y, torch.full((1, 2), 4.0))
    from repro_torch.configs.registry import all_configs
    for cfg in all_configs(smoke=True).values():
        assert build_model(cfg, device="cpu").cfg is cfg


def test_params_from_jax_splits_blocks_and_reads_bf16():
    import jax.numpy as jnp
    from repro_torch.convert import params_from_jax
    eye = np.eye(3, dtype=np.float32)
    scale = np.asarray(jnp.asarray([1.0, -2.5, 3.0e-3], jnp.bfloat16))
    tree = {"embed": np.ones((4, 3), np.float32),
            "blocks": {"attn": {"wq": np.stack([eye, 2 * eye])}},
            "final_norm": {"scale": scale}}
    sd = params_from_jax(tree)
    assert sorted(sd) == ["blocks.0.attn.wq", "blocks.1.attn.wq", "embed",
                          "final_norm.scale"]
    assert torch.equal(sd["blocks.1.attn.wq"], torch.from_numpy(2 * eye))
    assert sd["final_norm.scale"].dtype == torch.bfloat16
    assert torch.equal(sd["final_norm.scale"],
                       torch.tensor([1.0, -2.5, 3.0e-3], dtype=torch.bfloat16))
