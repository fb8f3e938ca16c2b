"""Rematerialization helper (counterpart of
``byteps_tpu/parallel/remat.py``)."""

from __future__ import annotations

from torch.utils.checkpoint import checkpoint


def maybe_remat(fn, remat: bool):
    """Wrap a per-layer block fn in activation checkpointing when
    ``remat`` is on: the block's activations are recomputed in the
    backward pass instead of kept (memory for FLOPs; numerics
    unchanged)."""
    if not remat:
        return fn

    def block(*args):
        return checkpoint(fn, *args, use_reentrant=False)

    return block
