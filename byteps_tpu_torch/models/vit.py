"""Vision Transformer: image classification on the GPT family's blocks.

Counterpart of ``byteps_tpu/models/vit.py``. Patchify is one reshape and
transpose of the NHWC images followed by one matmul (no convolution, no
gather); a mean-pooled head replaces a [CLS] token; the blocks are
``models/gpt.py``'s ``transformer_block`` with ``causal=False``, so tensor
parallelism and per-block remat compose as in the text families. As in
the reference, sequence parallelism is not plumbed: ViT's sequences are
``(image/patch)²`` ≈ 196 tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from byteps_tpu_torch.models.gpt import (
    ParamTree,
    _layernorm,
    _nll,
    block_init,
    block_logical_specs,
    transformer_block,
)
from byteps_tpu_torch.ops.backend import resolve_device
from byteps_tpu_torch.parallel.remat import maybe_remat
from byteps_tpu_torch.parallel.tp import pmean


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    n_classes: int = 1000
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.image_size % self.patch_size != 0:
            raise ValueError(
                f"image_size {self.image_size} not divisible by "
                f"patch_size {self.patch_size}"
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def tiny(cls) -> "ViTConfig":
        return cls(image_size=32, patch_size=8, channels=3, d_model=64,
                   n_heads=4, n_layers=2, d_ff=128, n_classes=10)

    @classmethod
    def base(cls) -> "ViTConfig":
        """ViT-B/16's shape, bf16 activations."""
        return cls(dtype=torch.bfloat16)


def vit_init(cfg: ViTConfig, generator: Optional[torch.Generator] = None,
             device=None) -> ParamTree:
    """Random parameters for ``cfg`` on ``device`` (the card unless told
    otherwise) from ``generator`` (default: seed 0 on that device)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d = cfg.d_model
    patch_dim = cfg.patch_size * cfg.patch_size * cfg.channels

    def dense(*shape):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * 0.02

    def const(n, v):
        return torch.full((n,), v, dtype=torch.float32, device=dev)

    tree = {
        "w_patch": dense(patch_dim, d), "b_patch": const(d, 0.0),
        "wpe": dense(cfg.n_patches, d),
        "blocks": [block_init(generator, d, cfg.d_ff,
                              cfg.n_heads * cfg.head_dim, cfg.n_layers,
                              device=dev)
                   for _ in range(cfg.n_layers)],
        "ln_f_g": const(d, 1.0), "ln_f_b": const(d, 0.0),
        "w_head": dense(d, cfg.n_classes),
        "b_head": const(cfg.n_classes, 0.0),
    }
    return ParamTree(cfg, tree)


def vit_logical_specs(cfg: ViTConfig) -> Dict[str, Any]:
    return {
        "w_patch": (None, "embed"), "b_patch": ("embed",),
        "wpe": (None, "embed"),
        "blocks": [block_logical_specs() for _ in range(cfg.n_layers)],
        "ln_f_g": ("embed",), "ln_f_b": ("embed",),
        "w_head": ("embed", None), "b_head": (None,),
    }


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) → (B, N, patch·patch·C) by reshape and transpose
    alone, in the reference's order: patches row-major, each patch's
    pixels row-major with channels innermost."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5)              # (B, gh, gw, p, p, C)
    return x.reshape(B, gh * gw, patch * patch * C)


def vit_forward(params, images: torch.Tensor, cfg: ViTConfig, tp_axis=None,
                remat: bool = False) -> torch.Tensor:
    """(B, H, W, C) images → f32 class logits (B, n_classes)."""
    x = patchify(images.to(cfg.dtype), cfg.patch_size)
    x = x @ params["w_patch"].to(x.dtype) + params["b_patch"].to(x.dtype)
    x = x + params["wpe"].to(x.dtype)

    def apply_block(x, p):
        return transformer_block(x, p, cfg.head_dim, tp_axis, None,
                                 causal=False)

    apply_block = maybe_remat(apply_block, remat)
    for p in params["blocks"]:
        x = apply_block(x, p)
    x = _layernorm(x, params["ln_f_g"], params["ln_f_b"])
    pooled = x.float().mean(dim=1)                         # (B, d)
    return pooled @ params["w_head"] + params["b_head"]


def vit_loss(params, images: torch.Tensor, labels: torch.Tensor,
             cfg: ViTConfig, dp_axis=None, tp_axis=None,
             remat: bool = False) -> torch.Tensor:
    """Mean softmax cross-entropy; the mean over ``dp_axis`` with one."""
    logits = vit_forward(params, images, cfg, tp_axis=tp_axis, remat=remat)
    return pmean(_nll(logits, labels).mean(), dp_axis)


def synthetic_vit_batch(generator: torch.Generator, cfg: ViTConfig,
                        batch: int):
    """Random ``(images, labels)``: (batch, H, W, C) f32 N(0, 1) images
    and (batch,) int64 labels, drawn from ``generator`` on its device."""
    dev = generator.device
    images = torch.randn((batch, cfg.image_size, cfg.image_size,
                          cfg.channels), generator=generator, device=dev)
    labels = torch.randint(0, cfg.n_classes, (batch,), generator=generator,
                           device=dev)
    return images, labels
