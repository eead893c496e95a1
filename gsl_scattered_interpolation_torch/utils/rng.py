"""Insertion-order shuffle (GSL's ``gsl_ran_shuffle``, randist/shuffle.c:69).

The scattered engine uses one piece of randomness: the randomized insertion
order of the incremental Delaunay build (linear_simplex.c:280-281).  The
JAX package draws it from threefry; here an int key seeds a
``torch.Generator``, which gives a different permutation for the same seed.
To reproduce a JAX build exactly, pass its permutation as the key.
"""

from __future__ import annotations

import numpy as np
import torch

from . import errors


def insertion_shuffle(key, n: int) -> np.ndarray:
    """A permutation of range(n) — the tree's ``shuffle`` (linear_simplex.h:50).

    ``key=None`` returns the identity, matching the reference when no rng is
    passed to ``simplex_tree_init`` (linear_simplex.c:269, 280-281).  An int
    seeds ``torch.randperm``; an array is taken as the permutation itself.
    """
    if key is None:
        return np.arange(n, dtype=np.int64)
    if isinstance(key, (int, np.integer)):
        gen = torch.Generator().manual_seed(int(key))
        return torch.randperm(n, generator=gen).numpy().astype(np.int64)
    perm = np.asarray(key, dtype=np.int64)
    if perm.shape != (n,) or not np.array_equal(np.sort(perm), np.arange(n)):
        raise errors.InvalidArgumentError(
            f"key must be None, an int or a permutation of range({n})"
        )
    return perm
