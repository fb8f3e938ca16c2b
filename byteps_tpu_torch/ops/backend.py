"""Device and kernel selection shared by every op module of the port.

The reference (``byteps_tpu/ops/backend.py``) chooses Pallas or jnp from
the JAX backend and an environment override. Here the tensor decides:
a CUDA tensor goes to the hand-written kernel, a CPU tensor to the
plain PyTorch version in the same module. There is no override and no
fallback: a kernel that does not build or launch raises.

Entry points (``gpt_init``, ``params_from_numpy``, ``make_generate_fn``,
``Scheduler``) run on the card unless the caller passes
``device="cpu"``; :func:`resolve_device` is that rule.

``launches`` holds one plain integer per kernel wrapper, bumped where
the wrapper launches its kernel and nowhere else, so a run can show
that its main path went through the kernels. ``flash_fwd_split`` counts
the forward's launches that took its split path (every ``flash_fwd``
launch is one or the other). ``segmented_lora_down`` and
``segmented_lora_up`` count the segmented LoRA kernel's two halves (the
row-parallel arm), ``segmented_lora`` its fused launches.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

launches: Dict[str, int] = {"flash_fwd": 0, "flash_fwd_split": 0,
                             "flash_decode": 0,
                             "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                             "onebit_pack": 0, "onebit_unpack_sum": 0,
                             "onebit_unpack_sum_grid": 0,
                             "topk_select": 0, "topk_reconstruct_sum": 0,
                             "topk_roundtrip": 0, "segmented_lora": 0,
                             "segmented_lora_down": 0,
                             "segmented_lora_up": 0,
                             "ring_rotate": 0, "ring_presum": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` or, when None, the card, as a concrete device (so it
    compares equal to a tensor's). Asking for CUDA on a machine without
    it raises instead of quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "byteps_tpu_torch runs on CUDA unless told otherwise and "
                "this machine has no CUDA device; pass device='cpu' to run "
                "the plain PyTorch versions")
        if dev.index is None:       # "cuda" → the concrete current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_kernel_input(t: torch.Tensor, name: str,
                       dtypes=(torch.float32, torch.bfloat16),
                       device: Optional[torch.device] = None) -> None:
    """The checks every wrapper makes before it hands a pointer to a
    kernel: on the card (on ``device`` when given, the card of the
    wrapper's other inputs), a dtype the kernel takes, contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor; got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} lives on {t.device}, the other inputs on "
                         f"{device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}; got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
