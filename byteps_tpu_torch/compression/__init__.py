"""Gradient compression for the port (reference:
``byteps_tpu/compression/``): the compressor interface and registry,
every codec of the reference (identity, onebit, topk, randomk,
dithering, fp16, fp8), and error feedback / Nesterov momentum as
explicit state the optimizer carries.

Selection mirrors the reference's ``compression_params`` dict, e.g.
``{"compressor": "topk", "k": 0.01, "ef": "vanilla", "selection":
"block"}``. onebit and block top-k run hand-written kernels on CUDA
tensors. The host-side wire codecs of the parameter-server tier live in
``compression/wire.py`` (imported on its own, not from here).
"""

from byteps_tpu_torch.compression.base import (  # noqa: F401
    Compressor,
    Payload,
    fold_in,
    from_params,
    get_compressor,
    register_compressor,
)
from byteps_tpu_torch.compression.dithering import (  # noqa: F401
    DitheringCompressor,
)
from byteps_tpu_torch.compression.error_feedback import (  # noqa: F401
    CompressionSpec,
    ef_compress,
    momentum_step,
)
from byteps_tpu_torch.compression.fp8 import Fp8Compressor  # noqa: F401
from byteps_tpu_torch.compression.fp16 import Fp16Compressor  # noqa: F401
from byteps_tpu_torch.compression.onebit import OnebitCompressor  # noqa: F401
from byteps_tpu_torch.compression.randomk import (  # noqa: F401
    RandomkCompressor,
)
from byteps_tpu_torch.compression.topk import TopkCompressor  # noqa: F401
