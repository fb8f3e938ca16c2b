"""Gradient compression for the port (reference:
``byteps_tpu/compression/``): the compressor interface and registry,
the onebit sign codec on the hand-written kernels, and error feedback /
Nesterov momentum as explicit state the optimizer carries.

Selection mirrors the reference's ``compression_params`` dict, e.g.
``{"compressor": "onebit", "ef": "vanilla"}``. Ported so far: identity
and onebit; the other codecs (topk, randomk, dithering, fp16, fp8) are
later slices and raise ``KeyError`` from :func:`get_compressor`.
"""

from byteps_tpu_torch.compression.base import (  # noqa: F401
    Compressor,
    Payload,
    from_params,
    get_compressor,
    register_compressor,
)
from byteps_tpu_torch.compression.error_feedback import (  # noqa: F401
    CompressionSpec,
    ef_compress,
    momentum_step,
)
from byteps_tpu_torch.compression.onebit import OnebitCompressor  # noqa: F401
