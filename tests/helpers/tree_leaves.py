"""A nested tree's leaves flattened, with no JAX: shared by the model
families' parity plumbing (``family_parity.py``) and their rank
processes (``family_rank.py``), which import torch and the port only."""

import numpy as np


def flat(tree) -> np.ndarray:
    """A nested tree's leaves in ``jax.tree.leaves`` order, flattened."""
    def leaves(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        if isinstance(t, (list, tuple)):
            return [x for v in t for x in leaves(v)]
        return [np.asarray(t).ravel()]
    return np.concatenate(leaves(tree))
