"""Checkpointing: atomic, async, retention-managed — the port of the JAX
package's ``checkpoint/manager.py``, on its on-disk layout::

    <dir>/step_00000100/
        manifest.json     # step, extra, each leaf's shape and dtype, time
        arrays.npz        # the flattened leaves, host copies
    <dir>/step_00000100.COMMITTED   # atomic commit marker

Fault-tolerance contract (``runtime/train_loop.py``):

- save is atomic: the payload is written into ``.tmp_step_…``, renamed
  into place, and only then is the marker written (by rename); a crash
  mid-save never corrupts the restore path, which picks the newest
  COMMITTED step;
- the host copy is taken before :meth:`CheckpointManager.save` returns
  (synchronous device-to-host copies): the train step updates parameters
  and moments in place, so a lazy copy would write a later step's values;
- async: serialization runs on a background thread; ``wait()`` joins it
  and re-raises its error.

Leaves are flattened as the reference flattens them (dict keys sorted,
joined with ``/``; list items by index).  A
:class:`repro_torch.convert.Stacked` leaf — one block parameter's
per-layer tensors — is stacked into one (L, …) array, so a train state
has the JAX state's paths and shapes (``convert.state_to_jax``).  A bf16
leaf is written as its raw 16 bits (int16) with ``"dtype": "bfloat16"``
in the manifest, and restored by the manifest's dtype; that also reads
the JAX package's bf16 leaves, which ``np.savez`` stores as raw ``|V2``
bytes (the reference's own ``restore`` cannot: ``jnp.asarray`` refuses
``|V2``).  Restoring onto another mesh (``shardings``) waits for the
distribution slice.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.convert import Stacked

BF16 = "bfloat16"


def _flatten(tree, prefix=""):
    flat = {}
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            flat.update(_flatten(tree[k], f"{prefix}/{k}" if prefix else k))
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, Stacked):
        for i, v in enumerate(tree):
            flat.update(_flatten(v, f"{prefix}/{i}"))
    else:
        flat[prefix] = tree
    return flat


def _unflatten(flat: dict[str, Any]):
    root: dict = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor as numpy can hold it: bf16 as its int16 bit patterns."""
    t = t.detach()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _host(leaf) -> tuple[np.ndarray, str]:
    """A host copy of ``leaf`` (tensor, :class:`Stacked`, numpy array or
    number), taken now, and its dtype's name."""
    if isinstance(leaf, Stacked):
        first = leaf[0]
        out = torch.empty((len(leaf), *first.shape),
                          dtype=_bits(first).dtype)
        for row, t in zip(out, leaf):
            row.copy_(_bits(t))     # device to host, into the stack
        return out.numpy(), str(first.dtype).removeprefix("torch.")
    if isinstance(leaf, torch.Tensor):
        arr = _bits(leaf).to("cpu", copy=True).numpy()
        return arr, str(leaf.dtype).removeprefix("torch.")
    arr = np.array(leaf)
    if arr.dtype.name == BF16:
        return arr.view(np.int16), BF16
    return arr, str(arr.dtype)


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A restored leaf: bf16 from its 16-bit patterns (int16 from the
    port, ``|V2`` from the JAX package), any other dtype as stored."""
    if dtype == BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # -------------------------------------------------------------- save
    def save(self, step: int, state: Any, extra: dict | None = None):
        """Snapshot to host memory now; write to disk (a)synchronously."""
        self.wait()
        host, leaves = {}, {}
        for k, v in _flatten(state).items():
            host[k], dtype = _host(v)
            leaves[k] = {"shape": list(host[k].shape), "dtype": dtype}
        meta = {"step": step, "extra": extra or {}, "leaves": leaves,
                "time": time.time()}
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, meta)

    def _write(self, step: int, host: dict, meta: dict):
        try:
            name = f"step_{step:08d}"
            tmp = os.path.join(self.dir, f".tmp_{name}")
            final = os.path.join(self.dir, name)
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"), **host)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            # atomic commit marker
            marker = os.path.join(self.dir, f"{name}.COMMITTED")
            with open(marker + ".tmp", "w") as f:
                f.write(str(meta["time"]))
            os.rename(marker + ".tmp", marker)
            self._gc()
        except Exception as e:  # noqa: BLE001
            self._error = e

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.committed_steps()
        for s in steps[:-self.keep]:
            name = f"step_{s:08d}"
            marker = os.path.join(self.dir, f"{name}.COMMITTED")
            if os.path.exists(marker):
                os.remove(marker)
            path = os.path.join(self.dir, name)
            if os.path.exists(path):
                shutil.rmtree(path)

    # ------------------------------------------------------------ restore
    def committed_steps(self) -> list[int]:
        steps = []
        for f in os.listdir(self.dir):
            if f.endswith(".COMMITTED"):
                steps.append(int(f[len("step_"):-len(".COMMITTED")]))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, shardings=None):
        """Load a checkpoint (the newest committed one by default):
        (nested dicts of CPU tensors, manifest), or (None, None) when
        nothing is committed.  ``shardings`` (elastic restore onto a
        mesh) is not ported yet."""
        if shardings is not None:
            raise NotImplementedError(
                "CheckpointManager.restore(shardings=...) waits for the "
                "distribution slice (parallel/sharding.py)")
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        name = f"step_{step:08d}"
        with open(os.path.join(self.dir, name, "manifest.json")) as f:
            meta = json.load(f)
        flat = {}
        with np.load(os.path.join(self.dir, name, "arrays.npz")) as npz:
            for k in npz.files:
                flat[k] = _tensor(npz[k], meta["leaves"][k]["dtype"])
        return _unflatten(flat), meta
