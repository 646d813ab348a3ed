"""The port's checkpoint manager: the reference's cases
(``tests/test_checkpoint.py``) against ``repro_torch.checkpoint``, bf16
leaves bit for bit (where the reference's own restore fails), the train
state's layout, and a JAX-written checkpoint resumed by the port's
training loop.

Tolerances: every restore is bit-exact.  The cross-package resume holds
the port's losses to the JAX loop's within rtol 2e-3 (bf16 activations
and products on both sides, as ``test_torch_train.py``'s LM steps).
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro.configs.registry import get_config as jax_config
from repro.data.pipeline import ShardedBatcher as JaxBatcher
from repro.data.pipeline import TokenSource as JaxSource
from repro.models import api as japi
from repro.optim import optimizers as jopt
from repro.runtime import train_loop as jtl
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.convert import state_from_jax, state_to_jax
from repro_torch.data.pipeline import ShardedBatcher, TokenSource
from repro_torch.models import api as tapi
from repro_torch.optim import optimizers as topt
from repro_torch.runtime import train_loop as ttl


def _state(v=0.0):
    return {"params": {"w": torch.full((4, 4), v), "b": torch.zeros((4,))},
            "opt": {"step": torch.tensor(3, dtype=torch.int32)}}


# ------------------------------------------------- the reference's cases
def test_roundtrip(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), async_save=False)
    ckpt.save(5, _state(1.5))
    state, meta = ckpt.restore()
    assert meta["step"] == 5
    np.testing.assert_array_equal(np.asarray(state["params"]["w"]),
                                  np.full((4, 4), 1.5))
    assert state["opt"]["step"].dtype == torch.int32
    assert meta["leaves"]["params/w"] == {"shape": [4, 4],
                                          "dtype": "float32"}


def test_latest_of_many(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), async_save=False, keep=10)
    for s in (1, 7, 3):
        ckpt.save(s, _state(float(s)))
    assert ckpt.latest_step() == 7
    state, _ = ckpt.restore(step=3)
    assert float(state["params"]["w"][0, 0]) == 3.0


def test_retention_gc(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), async_save=False, keep=2)
    for s in range(5):
        ckpt.save(s, _state())
    assert ckpt.committed_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == [
        "step_00000003", "step_00000003.COMMITTED", "step_00000004",
        "step_00000004.COMMITTED"]


def test_async_save_then_wait(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), async_save=True)
    ckpt.save(1, _state(2.0))
    ckpt.wait()
    state, meta = ckpt.restore()
    assert meta["step"] == 1


def test_uncommitted_checkpoint_ignored(tmp_path):
    """A crash mid-save (payload without marker) must be invisible."""
    ckpt = CheckpointManager(str(tmp_path), async_save=False)
    ckpt.save(1, _state(1.0))
    os.makedirs(tmp_path / "step_00000002")
    with open(tmp_path / "step_00000002" / "manifest.json", "w") as f:
        f.write("{}")
    assert ckpt.latest_step() == 1
    state, meta = ckpt.restore()
    assert meta["step"] == 1


def test_restore_empty_dir(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    state, meta = ckpt.restore()
    assert state is None and meta is None


def test_nested_tuple_state(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), async_save=False)
    ckpt.save(0, {"a": [torch.ones(2), np.zeros(3)]})
    restored, _ = ckpt.restore()
    # lists round-trip as index-keyed dicts (the reference's layout)
    np.testing.assert_array_equal(np.asarray(restored["a"]["0"]),
                                  np.ones(2))


# ------------------------------------------------------------ the port's
def test_snapshot_is_taken_before_save_returns(tmp_path):
    """The train step updates tensors in place, so save copies them
    before it returns: a write after save does not reach the file."""
    ckpt = CheckpointManager(str(tmp_path), async_save=True)
    state = _state(1.0)
    ckpt.save(0, state)
    state["params"]["w"].fill_(9.0)
    restored, _ = ckpt.restore()
    assert torch.equal(restored["params"]["w"], torch.full((4, 4), 1.0))


def _bf16_patterns() -> torch.Tensor:
    """Every bf16 class: normals, subnormals, ±0, ±inf, a NaN payload."""
    bits = np.array([0x3F80, 0xBF80, 0x0001, 0x8001, 0x0000, 0x8000,
                     0x7F80, 0xFF80, 0x7FC1, 0x4049, 0x3E4D, 0xC2F7],
                    dtype=np.uint16).view(np.int16)
    return torch.from_numpy(bits).view(torch.bfloat16)


@pytest.mark.parametrize("async_save", [False, True])
def test_bf16_leaf_roundtrip_bit_exact(tmp_path, async_save):
    ckpt = CheckpointManager(str(tmp_path), async_save=async_save)
    w = _bf16_patterns().reshape(3, 4)
    ckpt.save(0, {"w": w, "x": w.float()})
    restored, meta = ckpt.restore()
    assert meta["leaves"]["w"] == {"shape": [3, 4], "dtype": "bfloat16"}
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].view(torch.int16), w.view(torch.int16))
    assert torch.equal(restored["x"].view(torch.int32),
                       w.float().view(torch.int32))


def test_reference_bf16_restore_fault_is_read_by_the_port(tmp_path):
    """The reference writes a bf16 leaf as raw |V2 bytes and its own
    restore refuses them (jnp.asarray); the port's manager reads the same
    file by the manifest's dtype, bit for bit."""
    w = np.asarray(jnp.asarray(_bf16_patterns().float().numpy(),
                               jnp.bfloat16))
    jm = JaxManager(str(tmp_path), async_save=False)
    jm.save(4, {"params": {"w": jnp.asarray(w)},
                "opt": {"step": jnp.asarray(4, jnp.int32)}})
    with np.load(tmp_path / "step_00000004" / "arrays.npz") as npz:
        assert npz["params/w"].dtype.str == "|V2"
    with pytest.raises(TypeError, match="V2"):
        jm.restore()
    restored, meta = CheckpointManager(str(tmp_path)).restore()
    assert meta["leaves"]["params/w"]["dtype"] == "bfloat16"
    assert torch.equal(restored["params"]["w"].view(torch.int16),
                       torch.from_numpy(w.view(np.int16)))
    assert int(restored["opt"]["step"]) == 4


def test_restore_onto_a_mesh_waits(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), async_save=False)
    ckpt.save(0, _state())
    with pytest.raises(NotImplementedError, match="distribution"):
        ckpt.restore(shardings={"params/w": None})


@pytest.mark.parametrize("arch", ["starcoder2_3b", "zamba2_2p7b"])
def test_train_state_roundtrip_bit_exact(tmp_path, arch):
    """A bf16 train state (stacked block leaves, zamba2's unstacked
    shared block, fp32 moments and residuals) saved and restored into a
    fresh model: every parameter, moment and residual bit for bit."""
    cfg = get_config(arch, smoke=True).replace(param_dtype="bfloat16")
    model = tapi.build_model(cfg, device="cpu")
    opt = topt.adamw(1e-3)
    state = ttl.init_train_state(model, opt, 3, grad_compression=True)
    gen = torch.Generator().manual_seed(0)
    for t in topt.tree_leaves(state["opt"]) + topt.tree_leaves(
            state["residuals"]):
        if isinstance(t, torch.Tensor):
            t.normal_(generator=gen)
    state["opt"]["step"] = 7
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(6, state_to_jax(state))
    tree, meta = ckpt.restore()
    assert meta["leaves"]["params/embed"]["dtype"] == "bfloat16"
    assert meta["leaves"]["opt/m/embed"]["dtype"] == "float32"
    back = state_from_jax(tree, model)
    assert back["opt"]["step"] == 7
    want = topt.tree_leaves(state["params"].param_tree(per_block=True))
    got = topt.tree_leaves(back["params"].param_tree(per_block=True))
    assert [g.dtype for g in got] == [w.dtype for w in want]
    assert all(torch.equal(g.view(torch.int16), w.view(torch.int16))
               for g, w in zip(got, want))
    for key in ("m", "v"):
        assert all(torch.equal(g, w) for g, w in zip(
            topt.tree_leaves(back["opt"][key]),
            topt.tree_leaves(state["opt"][key])))
    assert all(torch.equal(g, w) for g, w in zip(
        topt.tree_leaves(back["residuals"]),
        topt.tree_leaves(state["residuals"])))
    wrong = tapi.build_model(get_config(arch, smoke=True), device="cpu")
    with pytest.raises(ValueError, match="params/"):
        state_from_jax(tree, wrong)        # fp32 model, bf16 checkpoint


def test_port_resumes_a_jax_checkpoint(tmp_path):
    """The JAX loop writes its step -1 snapshot of qwen2-smoke (fp32
    parameters); the port's loop resumes from a copy of that directory
    and its losses over the same steps equal the JAX loop's."""
    steps = 4
    cfg = jax_config("qwen2_7b", smoke=True)
    jbatcher = JaxBatcher(JaxSource(cfg.vocab_size, 4, 32), rules=None,
                          prefetch=False)
    jrep = jtl.train_loop(japi.build_model(cfg), steps=steps,
                          batcher=jbatcher,
                          ckpt=JaxManager(str(tmp_path / "jax"),
                                          async_save=False),
                          optimizer=jopt.adamw(1e-3), ckpt_every=100)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    for s in JaxManager(str(tmp_path / "port")).committed_steps()[1:]:
        os.remove(tmp_path / "port" / f"step_{s:08d}.COMMITTED")
    ckpt = CheckpointManager(str(tmp_path / "port"))
    assert ckpt.committed_steps() == [-1]
    tree, _ = ckpt.restore()
    assert tree["params"]["embed"].dtype == torch.float32
    tcfg = get_config("qwen2_7b", smoke=True)
    batcher = ShardedBatcher(TokenSource(tcfg.vocab_size, 4, 32), None,
                             prefetch=False, device="cpu")
    trep = ttl.train_loop(tapi.build_model(tcfg, device="cpu"), steps=steps,
                          batcher=batcher, ckpt=ckpt,
                          optimizer=topt.adamw(1e-3), ckpt_every=100,
                          seed=99)      # the seed is unused: it resumes
    assert trep.steps_run == jrep.steps_run == steps
    np.testing.assert_allclose(trep.losses, jrep.losses, rtol=2e-3)
    assert ckpt.committed_steps() == [-1, steps - 1]
