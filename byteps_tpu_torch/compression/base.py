"""Compressor interface + registry (counterpart of
``byteps_tpu/compression/base.py``).

Contract, as in the reference:

* ``compress(x, rng=None) -> payload`` — ``x`` is a 1-D tensor;
  ``payload`` is a dict of tensors whose shapes depend only on ``x``'s
  length and the configuration.
* ``decompress(payload, n, dtype, rng=None) -> x_hat`` — back to a dense
  1-D tensor of length ``n``.
* ``decompress_sum(payloads, n, dtype)`` — Σ_k decompress(payload_k) over
  a stacked payload (leading axis K): the aggregation tier's inner loop.
* ``compressed_bytes(n, itemsize)`` — wire size, for accounting.

Keys. The reference threads threefry keys; here a key is a Python int
below 2^64, :func:`fold_in` derives one from another as
``jax.random.fold_in`` does (the step's key from the seed and the step
count, a chunk's from the step's, a segment's from the chunk's), and a
stochastic codec draws from ``torch.Generator(device).manual_seed(key)``
(:func:`generator`). The draws differ from the reference's; each
stochastic codec keeps its draw step apart from a deterministic apply
step, so a test can feed it the reference's draws. Stochastic codecs
(``stochastic = True``) raise without a key, as the reference's do;
deterministic ones ignore it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

Payload = Dict[str, torch.Tensor]

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def fold_in(key: int, data: int) -> int:
    """A new key from ``key`` and the integer ``data``: splitmix64 of
    ``key ^ (data · φ)`` (φ the 64-bit golden ratio), mod 2^64."""
    z = (int(key) ^ (int(data) * _GOLDEN)) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def generator(key: int, device: torch.device) -> torch.Generator:
    """The generator a stochastic codec draws from for ``key``."""
    return torch.Generator(device).manual_seed(int(key))


class Compressor:
    """Base compressor; identity by default."""

    name = "identity"
    # payloads from different workers sum positionally without
    # decompressing (identity): the aggregation tier then skips
    # decompress-sum-recompress
    presummable = True
    # compress/decompress need an rng advancing every step
    stochastic = False

    def compress(self, x: torch.Tensor, rng=None) -> Payload:
        return {"values": x}

    def decompress(self, payload: Payload, n: int,
                   dtype: torch.dtype = torch.float32,
                   rng=None) -> torch.Tensor:
        return payload["values"].to(dtype)

    def decompress_sum(self, payloads: Payload, n: int,
                       dtype: torch.dtype = torch.float32,
                       rng_keys=None) -> torch.Tensor:
        """Σ_k decompress(payload_k), folded in worker order k = 0..K-1.
        Subclasses override with fused kernels."""
        K = next(iter(payloads.values())).shape[0]
        acc = None
        for r in range(K):
            d = self.decompress({k: v[r] for k, v in payloads.items()}, n,
                                dtype)
            acc = d if acc is None else acc + d
        return acc

    def roundtrip(self, x: torch.Tensor, rng=None,
                  e: Optional[torch.Tensor] = None):
        """With ``xin = x + e`` (or just ``x``): ``(D(C(xin)),
        xin − D(C(xin)))`` — the single-worker aggregation body plus the
        error-feedback add and residual. Matches the n == 1 collective
        exactly for deterministic codecs (D∘C is idempotent)."""
        xin = x if e is None else x + e
        dense = self.decompress(self.compress(xin, rng), x.shape[0],
                                torch.float32, rng)
        return dense, xin - dense

    def compressed_bytes(self, n: int, itemsize: int = 4) -> int:
        return n * itemsize

    def __repr__(self) -> str:  # pragma: no cover
        return f"<{type(self).__name__}>"


_REGISTRY: Dict[str, Callable[..., Compressor]] = {}


def register_compressor(name: str):
    def deco(factory: Callable[..., Compressor]):
        _REGISTRY[name] = factory
        return factory

    return deco


def get_compressor(name: str, **kwargs: Any) -> Compressor:
    if name in (None, "", "identity", "none"):
        return Compressor()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown compressor '{name}'; registered: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](**kwargs)


def from_params(params: Optional[Dict[str, Any]]):
    """Parse a reference-style ``compression_params`` dict into a
    :class:`~byteps_tpu_torch.compression.error_feedback.CompressionSpec`."""
    from byteps_tpu_torch.compression.error_feedback import CompressionSpec

    params = dict(params or {})
    name = params.pop("compressor", None)
    ef = params.pop("ef", None)
    momentum = params.pop("momentum", None)
    mu = params.pop("mu", 0.9)
    seed = params.pop("seed", 0)
    two_way = params.pop("two_way", True)
    compressor = get_compressor(name, **params) if name else Compressor()
    return CompressionSpec(
        compressor=compressor,
        ef=ef in ("vanilla", True, "1"),
        momentum=momentum in ("nesterov", True, "1"),
        mu=mu,
        seed=seed,
        two_way=bool(two_way),
    )
