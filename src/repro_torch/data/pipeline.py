"""Deterministic data pipeline: the port of the JAX package's
``data/pipeline.py``.

- :class:`TokenSource` yields fixed-shape (B, S) token/label batches from
  a flat token stream (``data/synthetic.py::lm_tokens``), indexed by
  ``step`` through ``np.random.default_rng(step)`` — so a restart from
  checkpoint step k reproduces batch k exactly (the data state of
  fault-tolerant training is the step counter), and both packages draw
  the same integers for every step.  With ``frames`` (an enc-dec
  model's ``(n_frames, d_model)``) a batch also carries stub
  conv-frontend embeddings, ``0.1 · N(0, 1)`` in fp32 drawn after the
  tokens from the same generator (the JAX package's pipeline has none,
  so its launcher cannot train whisper).
- :class:`ShardedBatcher` places host batches on the model's device,
  prefetching one batch ahead on a thread; with ``rules`` each rank
  places its rows of the global batch as a DTensor sharded on batch over
  the mesh's data-parallel axes (the global batch is the one
  ``rules=None`` gives: every rank draws it from the same step).
"""

from __future__ import annotations

import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.data.synthetic import lm_tokens
from repro_torch.models.common import resolve_device
from repro_torch.parallel.sharding import local_slice


class TokenSource:
    """Deterministic step → batch mapping over a synthetic token stream."""

    def __init__(self, vocab: int, batch: int, seq_len: int,
                 n_tokens: int = 1 << 20, seed: int = 0,
                 frames: tuple[int, int] | None = None):
        self.vocab = vocab
        self.batch = batch
        self.seq_len = seq_len
        self.frames = frames
        self.stream = lm_tokens(n_tokens, vocab, seed)
        self.n_windows = (len(self.stream) - 1) // seq_len

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(step)  # deterministic in step
        idx = rng.integers(0, self.n_windows, self.batch)
        starts = idx * self.seq_len
        toks = np.stack([self.stream[s:s + self.seq_len] for s in starts])
        labels = np.stack([self.stream[s + 1:s + 1 + self.seq_len]
                           for s in starts])
        out = {"tokens": toks, "labels": labels}
        if self.frames is not None:
            out["frames"] = (rng.standard_normal((self.batch, *self.frames))
                             * 0.1).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class ShardedBatcher:
    """Places host batches on ``device`` — the model's; CUDA unless the
    caller names another — as int64 tensors holding the integers of
    :meth:`TokenSource.batch_at` (fp32 frames as they are), one batch
    ahead on a thread with
    ``prefetch``.  With ``rules`` (``parallel/sharding.py``) a batch is a
    DTensor on ``rules.mesh``, its rows sharded by the ``batch`` rule
    (replicated where they do not divide); this rank copies only its
    rows to the device."""

    def __init__(self, source: TokenSource, rules=None,
                 prefetch: bool = True,
                 device: str | torch.device | None = None):
        self.source = source
        self.rules = rules
        self.prefetch = prefetch
        self.device = resolve_device(device)
        self._next: tuple | None = None
        self._thread: threading.Thread | None = None

    def _place(self, batch: dict[str, np.ndarray]) -> dict:
        def host(v):
            t = torch.from_numpy(v)
            return t if t.is_floating_point() else t.long()
        if self.rules is None:
            return {k: host(v).to(self.device) for k, v in batch.items()}
        from torch.distributed.tensor import DTensor
        out = {}
        for k, v in batch.items():
            sh = self.rules.sharding_for(("batch",) + (None,) * (v.ndim - 1),
                                         v.shape)
            rows = local_slice(host(v), sh.mesh, sh.placements)
            out[k] = DTensor.from_local(rows.to(self.device), sh.mesh,
                                        sh.placements, run_check=False)
        return out

    def get(self, step: int) -> dict:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._next is not None and self._next[0] == step:
            batch = self._next[1]
        else:
            batch = self._place(self.source.batch_at(step))
        self._next = None
        if self.prefetch:
            def work(s):
                self._next = (s, self._place(self.source.batch_at(s)))
            self._thread = threading.Thread(target=work, args=(step + 1,),
                                            daemon=True)
            self._thread.start()
        return batch
