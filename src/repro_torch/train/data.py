"""Synthetic data for the paper's training workloads
(``repro/train/data.py``): regression tasks with a planted model,
MNIST-like 784-feature classification, and an LM token stream for the
transformer archs.  Batches are a pure function of (seed, step), so a
restarted trainer resumes mid-epoch with identical batches.  numpy only,
drawn as the JAX package draws them (same RandomState calls, same order),
so both packages train on the same data.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RegressionData:
    """y = X w* + noise, for linear/logistic regression training."""
    features: int
    n: int = 4096
    seed: int = 0
    logistic: bool = False

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        self.w_star = rng.randn(self.features, 1) * 0.5
        self.X = rng.randn(self.n, self.features).astype(np.float64)
        z = self.X @ self.w_star + 0.01 * rng.randn(self.n, 1)
        if self.logistic:
            self.y = (z > 0).astype(np.float64)
        else:
            self.y = z

    def batch(self, step: int, bsz: int):
        rng = np.random.RandomState(self.seed ^ (step * 2654435761 % 2**31))
        idx = rng.randint(0, self.n, bsz)
        return self.X[idx], self.y[idx]


@dataclasses.dataclass
class MNISTLike:
    """784-feature, 10-class synthetic images (class-dependent templates +
    noise): stands in for MNIST without a download."""
    n: int = 8192
    seed: int = 0
    features: int = 784
    classes: int = 10

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        self.templates = rng.randn(self.classes, self.features) * 0.8
        self.labels = rng.randint(0, self.classes, self.n)
        self.X = (self.templates[self.labels]
                  + rng.randn(self.n, self.features) * 0.7).astype(
                      np.float64)

    def batch(self, step: int, bsz: int):
        rng = np.random.RandomState(self.seed ^ (step * 2654435761 % 2**31))
        idx = rng.randint(0, self.n, bsz)
        onehot = np.eye(self.classes)[self.labels[idx]]
        return self.X[idx], onehot, self.labels[idx]


@dataclasses.dataclass
class TokenStream:
    """Synthetic LM corpus: a Markov bigram chain over `vocab` (each token
    strongly predicts 4 successors, one token in 10 is noise), so a model
    has structure to learn.  ``batch`` gives (ids, labels), int32 (bsz,
    seq), the labels the ids shifted by one."""
    vocab: int
    seed: int = 0
    order: int = 1

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        self.next_tok = rng.randint(0, self.vocab, (self.vocab, 4))

    def batch(self, step: int, bsz: int, seq: int):
        rng = np.random.RandomState(self.seed ^ (step * 40503 % 2**31))
        toks = np.empty((bsz, seq + 1), np.int32)
        toks[:, 0] = rng.randint(0, self.vocab, bsz)
        for t in range(seq):
            choice = rng.randint(0, 4, bsz)
            noise = rng.random(bsz) < 0.1
            nxt = self.next_tok[toks[:, t], choice]
            nxt = np.where(noise, rng.randint(0, self.vocab, bsz), nxt)
            toks[:, t + 1] = nxt
        return toks[:, :-1], toks[:, 1:]
