"""The one traffic generator: a mix's JSON file in, a seeded request
stream out.

Every seed gives the same multiset of sizes and gaps in another order:
the stream comes in blocks of ``block`` requests, and each block is a
seeded permutation of one fixed grid of quantiles (``(i + 0.5) / block``)
of each length distribution and of the arrival gaps.  Token contents are
drawn from the seed.  So two seeds do the same work, and a run's spread
is the system's, not the draw's.

Keys of a mix (see ``perfbench/traffic/*.json``):

- ``loop``: ``"closed"`` (``clients`` clients, each sending its next
  request when the last one completes, no think time) or ``"open"``
  (arrivals at ``rate_per_s``, exponential gaps, sent whether or not
  earlier requests finished);
- ``prompt_tokens``: a length distribution of unshared prompts, or
- ``documents`` (``count``, ``tokens``, ``zipf_s``) and
  ``question_tokens``: each prompt is one of ``count`` documents, drawn
  Zipf(``zipf_s``) by popularity rank and cut to whole pages, followed by
  an unshared question; ``retain_documents`` sizes the prefix cache's
  retention to hold about that many documents;
- ``answer_tokens``: the number of tokens generated (greedy);
- ``block``, ``warmup_requests``: the permutation block and how many
  requests set-up serves before the window opens.

A length distribution is ``{"dist": "uniform" | "loguniform", "min": a,
"max": b}`` over whole numbers in ``[a, b]``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def _entropy(seed: int, *tags: int) -> list[int]:
    s = int(seed) % (1 << 64)
    return [s & 0xFFFFFFFF, s >> 32, *tags]


def seeded_rng(seed: int, *tags: int) -> np.random.Generator:
    """A generator for ``seed`` (any whole number) and stream ``tags``."""
    return np.random.default_rng(np.random.SeedSequence(_entropy(seed,
                                                                 *tags)))


def quantile(dist: dict, u: np.ndarray) -> np.ndarray:
    """Whole-number quantiles of a length distribution at ``u`` in (0, 1)."""
    a, b = int(dist["min"]), int(dist["max"])
    if dist["dist"] == "uniform":
        return np.minimum(a + np.floor(u * (b - a + 1)), b).astype(np.int64)
    if dist["dist"] == "loguniform":
        v = np.exp(math.log(a) + u * (math.log(b) - math.log(a)))
        return np.clip(np.round(v), a, b).astype(np.int64)
    raise ValueError(f"unknown length distribution {dist['dist']!r}")


def grid(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def zipf_counts(count: int, s: float, total: int) -> np.ndarray:
    """How many of ``total`` requests go to each popularity rank under
    Zipf(``s``), rounded by largest remainder so they sum to ``total``."""
    w = 1.0 / np.arange(1, count + 1) ** s
    exact = total * w / w.sum()
    out = np.floor(exact).astype(np.int64)
    rest = total - int(out.sum())
    out[np.argsort(-(exact - out), kind="stable")[:rest]] += 1
    return out


@dataclasses.dataclass
class Item:
    """One generated request: its prompt, answer length, the gap after
    the previous arrival (open loop) and its document (-1: none)."""
    index: int
    prompt: np.ndarray
    max_new_tokens: int
    gap_s: float
    doc: int


class Stream:
    """The seeded request stream of one mix; ``item(i)`` is request ``i``
    (generated on demand, the same for the same seed)."""

    def __init__(self, mix: dict, seed: int, vocab: int, page_size: int):
        self.mix, self.seed, self.vocab = mix, int(seed), int(vocab)
        self.page_size = int(page_size)
        self.block = int(mix.get("block", 256))
        u = grid(self.block)
        self._answers = quantile(mix["answer_tokens"], u)
        self.docs = mix.get("documents")
        if self.docs is None:
            self._prompts = quantile(mix["prompt_tokens"], u)
        else:
            n = int(self.docs["count"])
            lens = quantile(self.docs["tokens"], grid(n))
            lens = lens // self.page_size * self.page_size
            # which popularity rank gets which length is fixed, not drawn,
            # so every seed's documents weigh the same
            self.doc_lens = lens[np.random.default_rng(0).permutation(n)]
            self._docs_per_block = np.repeat(
                np.arange(n), zipf_counts(n, float(self.docs["zipf_s"]),
                                          self.block))
            self._questions = quantile(mix["question_tokens"], u)
            self._doc_tokens: dict[int, np.ndarray] = {}
        self.rate = mix.get("rate_per_s")
        if self.rate is not None:
            self._gaps = -np.log1p(-u) / float(self.rate)
        self._blocks: dict[int, dict] = {}

    # ----------------------------------------------------------- sizes
    @property
    def max_prompt_tokens(self) -> int:
        if self.docs is None:
            return int(self._prompts.max())
        return int(self.doc_lens.max() + self._questions.max())

    @property
    def max_answer_tokens(self) -> int:
        return int(self._answers.max())

    @property
    def retain_pages(self) -> int:
        """Retention pages for about ``retain_documents`` documents of
        mean length (0 without documents)."""
        if self.docs is None:
            return 0
        mean_pages = float(self.doc_lens.mean()) / self.page_size
        return int(math.ceil(int(self.mix.get("retain_documents", 0))
                             * mean_pages))

    # ---------------------------------------------------------- stream
    def _block(self, b: int) -> dict:
        got = self._blocks.get(b)
        if got is None:
            rng = seeded_rng(self.seed, 1, b)
            got = {"answer": rng.permutation(self._answers)}
            if self.docs is None:
                got["prompt"] = rng.permutation(self._prompts)
            else:
                got["doc"] = rng.permutation(self._docs_per_block)
                got["question"] = rng.permutation(self._questions)
            if self.rate is not None:
                got["gap"] = rng.permutation(self._gaps)
            self._blocks = {b: got}      # one block kept: the stream only
        return got                       # moves forward

    def doc_tokens(self, d: int) -> np.ndarray:
        t = self._doc_tokens.get(d)
        if t is None:
            t = seeded_rng(self.seed, 2, d).integers(
                0, self.vocab, int(self.doc_lens[d]), dtype=np.int64)
            t = self._doc_tokens[d] = t.astype(np.int32)
        return t

    def item(self, i: int) -> Item:
        b, j = divmod(int(i), self.block)
        blk = self._block(b)
        rng = seeded_rng(self.seed, 3, i)
        doc = -1
        if self.docs is None:
            prompt = rng.integers(0, self.vocab, int(blk["prompt"][j]),
                                  dtype=np.int64).astype(np.int32)
        else:
            doc = int(blk["doc"][j])
            q = rng.integers(0, self.vocab, int(blk["question"][j]),
                             dtype=np.int64).astype(np.int32)
            prompt = np.concatenate([self.doc_tokens(doc), q])
        gap = float(blk["gap"][j]) if self.rate is not None else 0.0
        return Item(index=int(i), prompt=prompt,
                    max_new_tokens=int(blk["answer"][j]), gap_s=gap, doc=doc)
