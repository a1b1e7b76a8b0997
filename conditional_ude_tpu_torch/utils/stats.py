"""Statistics utilities (counterpart of ``conditional_ude_tpu/utils/stats.py``).

* ``stratified_split``: per-class sampling that keeps the NGT/IGT/T2DM
  proportions;
* ``latin_hypercube``: the β design of joint training;
* ``spearman``: rank correlation of β against the clamp indices.
"""

from __future__ import annotations

import numpy as np
from scipy import stats as _sstats


def stratified_split(rng: np.random.Generator, types, f_train: float):
    """Per-class sampling without replacement; returns (train_idx, test_idx).

    Classes in order of first appearance; ``n_train`` rounds half to even.
    """
    types = np.asarray(types)
    train = []
    _, first_idx = np.unique(types, return_index=True)
    for t in types[np.sort(first_idx)]:
        idx = np.flatnonzero(types == t)
        n_train = int(np.round(f_train * len(idx)))
        train.extend(rng.choice(idx, size=n_train, replace=False))
    train = np.sort(np.asarray(train, dtype=np.int64))
    test = np.setdiff1d(np.arange(len(types)), train)
    return train, test


def latin_hypercube(rng: np.random.Generator, n_samples: int, dims: int,
                    lower: float, upper: float) -> np.ndarray:
    """Latin hypercube sample in [lower, upper]^dims, shape [n_samples, dims];
    per dimension one permutation and one uniform draw, so a numpy seed
    gives the JAX package's design bit for bit."""
    out = np.empty((n_samples, dims))
    for d in range(dims):
        perm = rng.permutation(n_samples)
        u = rng.uniform(size=n_samples)
        out[:, d] = (perm + u) / n_samples
    return lower + out * (upper - lower)


def spearman(x, y) -> float:
    """Spearman rank correlation (average ranks for ties)."""
    return float(_sstats.spearmanr(np.asarray(x), np.asarray(y)).statistic)
