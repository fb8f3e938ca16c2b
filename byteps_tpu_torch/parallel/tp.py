"""Tensor-parallel building blocks at tp = 1.

Counterpart of ``byteps_tpu/parallel/tp.py``: the column- and
row-parallel projections the model code is written against. This slice
runs on one card, so no axis exists; naming one raises until tensor
parallelism is ported.
"""

from __future__ import annotations

from typing import Optional

import torch


def col_parallel_matmul(x: torch.Tensor, w: torch.Tensor,
                        b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w (+ b): ``w`` is stored ``(d_in, d_out)``."""
    y = x @ w
    if b is not None:
        y = y + b
    return y


def row_parallel_matmul(x: torch.Tensor, w: torch.Tensor,
                        axis: Optional[str],
                        b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w (+ b); at tp > 1 the product would be summed over
    ``axis`` before the bias."""
    if axis is not None:
        raise NotImplementedError(
            f"tensor parallelism over {axis!r} is not ported yet: the port "
            "runs at tp = 1")
    y = x @ w
    if b is not None:
        y = y + b
    return y
