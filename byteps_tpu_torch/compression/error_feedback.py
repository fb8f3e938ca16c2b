"""Error feedback and Nesterov momentum (counterpart of
``byteps_tpu/compression/error_feedback.py``).

The reference keeps this state in pytrees its optimizer threads through
the jitted step; here it is plain per-rank f32 tensors that
:class:`byteps_tpu_torch.optimizer.DistributedOptimizer` holds.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from byteps_tpu_torch.compression.base import Compressor, Payload


@dataclasses.dataclass
class CompressionSpec:
    """Resolved compression configuration for one tensor/partition."""

    compressor: Compressor
    ef: bool = False
    momentum: bool = False
    mu: float = 0.9
    seed: int = 0
    # compress the pull direction too (the server re-compresses the sum
    # before answering pulls); its recompression error is not covered by
    # worker-side error feedback
    two_way: bool = True

    @property
    def enabled(self) -> bool:
        return self.compressor.name != "identity"


def momentum_step(x: torch.Tensor, m: torch.Tensor,
                  mu: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nesterov momentum pre-compression: m' = μm + x; out = x + μm'."""
    m_new = mu * m + x
    return x + mu * m_new, m_new


def ef_compress(compressor: Compressor, x: torch.Tensor, e: torch.Tensor,
                rng=None) -> Tuple[Payload, torch.Tensor]:
    """Compress with error feedback: corrected = x + e; payload =
    C(corrected); e' = corrected − D(payload)."""
    corrected = x.float() + e
    payload = compressor.compress(corrected, rng)
    approx = compressor.decompress(payload, corrected.shape[0],
                                   torch.float32, rng)
    return payload, corrected - approx
