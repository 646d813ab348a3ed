"""Synthetic datasets shaped like the paper's benchmarks + LM token streams.

numpy only, so the same seed gives the same arrays as the JAX package's
``data/synthetic.py`` (the port's own copy: it imports nothing of that
package).  Each generator produces a *learnable* synthetic task with the
original input shape and class count, in place of the Jet-HLF / MNIST /
SVHN files the repository does not hold.

- jet: 16-feature 5-class Gaussian-mixture with class-dependent covariance
  (mimics the HLS4ML jet-substructure tagging problem).
- mnist_like: 28x28x1 images — class-dependent oriented bar patterns+noise.
- svhn_like: 32x32x3 images — class-dependent colour/texture statistics.
- lm_tokens: Zipf-distributed token stream with a Markov flavour so a
  language model has something to learn.
"""

from __future__ import annotations

import numpy as np


def jet_dataset(n: int = 4096, seed: int = 0, n_features: int = 16,
                n_classes: int = 5):
    rng = np.random.default_rng(seed)
    means = rng.normal(0, 1.5, (n_classes, n_features))
    scales = rng.uniform(0.5, 1.5, (n_classes, n_features))
    y = rng.integers(0, n_classes, n)
    x = means[y] + rng.normal(0, 1.0, (n, n_features)) * scales[y]
    # nonlinear structure so depth matters
    x[:, ::2] += 0.3 * np.sin(x[:, 1::2])
    return x.astype(np.float32), y.astype(np.int32)


def _pattern_images(n, seed, size, channels, n_classes):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, n)
    xs = np.zeros((n, size, size, channels), np.float32)
    yy, xx = np.mgrid[0:size, 0:size] / size
    for c in range(n_classes):
        idx = np.where(y == c)[0]
        angle = np.pi * c / n_classes
        freq = 2 + c % 4
        base = np.sin(2 * np.pi * freq
                      * (np.cos(angle) * xx + np.sin(angle) * yy))
        for ch in range(channels):
            phase = ch * 0.7 + c * 0.3
            xs[idx, :, :, ch] = base * np.cos(phase) + 0.2 * c / n_classes
    xs += rng.normal(0, 0.35, xs.shape).astype(np.float32)
    return xs, y.astype(np.int32)


def mnist_like(n: int = 2048, seed: int = 0):
    return _pattern_images(n, seed, 28, 1, 10)


def svhn_like(n: int = 2048, seed: int = 0):
    return _pattern_images(n, seed, 32, 3, 10)


def lm_tokens(n_tokens: int, vocab: int, seed: int = 0,
              zipf_a: float = 1.2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = rng.zipf(zipf_a, n_tokens).astype(np.int64)
    toks = base % vocab
    # inject bigram structure: token2i+1 depends on token2i
    n_odd = len(toks[1::2])
    toks[1::2] = (toks[0::2][:n_odd] * 31 + 7) % vocab
    return toks.astype(np.int32)


DATASETS = {
    "jet": jet_dataset,
    "mnist_like": mnist_like,
    "svhn_like": svhn_like,
}


def train_test_split(x, y, test_frac: float = 0.2, seed: int = 0):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    n_test = int(len(x) * test_frac)
    te, tr = idx[:n_test], idx[n_test:]
    return (x[tr], y[tr]), (x[te], y[te])
