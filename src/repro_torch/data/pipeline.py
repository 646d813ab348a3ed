"""Deterministic data pipeline: the port of the JAX package's
``data/pipeline.py``.

- :class:`TokenSource` yields fixed-shape (B, S) token/label batches from
  a flat token stream (``data/synthetic.py::lm_tokens``), indexed by
  ``step`` through ``np.random.default_rng(step)`` — so a restart from
  checkpoint step k reproduces batch k exactly (the data state of
  fault-tolerant training is the step counter), and both packages draw
  the same integers for every step.
- :class:`ShardedBatcher` places host batches on the model's device,
  prefetching one batch ahead on a thread.  Placement over a mesh
  (``rules``) waits for the port of ``parallel/sharding.py``.
"""

from __future__ import annotations

import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.data.synthetic import lm_tokens
from repro_torch.models.common import resolve_device


class TokenSource:
    """Deterministic step → batch mapping over a synthetic token stream."""

    def __init__(self, vocab: int, batch: int, seq_len: int,
                 n_tokens: int = 1 << 20, seed: int = 0):
        self.vocab = vocab
        self.batch = batch
        self.seq_len = seq_len
        self.stream = lm_tokens(n_tokens, vocab, seed)
        self.n_windows = (len(self.stream) - 1) // seq_len

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(step)  # deterministic in step
        idx = rng.integers(0, self.n_windows, self.batch)
        starts = idx * self.seq_len
        toks = np.stack([self.stream[s:s + self.seq_len] for s in starts])
        labels = np.stack([self.stream[s + 1:s + 1 + self.seq_len]
                           for s in starts])
        return {"tokens": toks, "labels": labels}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class ShardedBatcher:
    """Places host batches on ``device`` — the model's; CUDA unless the
    caller names another — as int64 tensors holding the integers of
    :meth:`TokenSource.batch_at`, one batch ahead on a thread with
    ``prefetch``.  ``rules`` is the JAX package's sharding rules: only
    ``None`` (one device) is ported."""

    def __init__(self, source: TokenSource, rules=None,
                 prefetch: bool = True,
                 device: str | torch.device | None = None):
        if rules is not None:
            raise NotImplementedError(
                "ShardedBatcher: placement over a mesh (rules) waits for the "
                "distribution slice (parallel/sharding.py); pass rules=None")
        self.source = source
        self.rules = rules
        self.prefetch = prefetch
        self.device = resolve_device(device)
        self._next: tuple | None = None
        self._thread: threading.Thread | None = None

    def _place(self, batch: dict[str, np.ndarray]) -> dict:
        return {k: torch.from_numpy(v).long().to(self.device)
                for k, v in batch.items()}

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
