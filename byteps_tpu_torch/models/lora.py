"""LoRA adapters for the GPT family, forward only: grafting, the delta
the model adds beside each frozen matmul, pool slabs and merging.

Counterpart of ``byteps_tpu/models/lora.py``. Adapters live in their own
tree, ``{"blocks": [{target: {"a": (d_in, r), "b": (r, d_out)}}]}``; the
forward grafts each block's adapters under a ``"lora"`` key with the
``scale`` folded into ``b``, and the model adds ``(x @ a) @ b`` beside
the frozen ``x @ w`` of each target (``gpt._attention``/``_mlp``,
``generate._attn_cached_half``). The ``(d, d)`` product is never built.

:func:`lora_delta` runs through ``ops/segmented_lora.segmented_lora_delta``
with a one-slot slab and every row on slot 0, so the solo step, a prefill
chunk and the serve tier's packed decode (which gathers from the
``AdapterPool`` slabs) all run one function with the same arithmetic per
row: the kernel on the card, the plain version on the CPU. That is what
keeps a pooled tenant's tokens equal to a solo run on its grafted tree.

The reference fences its dots with ``optimization_barrier`` (``_fence``)
to pin XLA's fusion; PyTorch runs eagerly, so nothing here needs one.
LoRA training is a later slice: on the card :func:`lora_delta` refuses a
gradient rather than return a wrong one.

On a tensor-parallel mesh (:func:`lora_param_specs`, the reference's) a
column-parallel target's ``b`` is split on its output dim, like its
frozen weight, and needs no collective; a row-parallel target's (``wo``,
``w2``) ``a`` is split on its input dim, and its thin ``(..., r)``
intermediate is summed over tp between the two products: the segmented
kernel's row-parallel arm (``lora_delta(..., tp_axis)``).
"""

from __future__ import annotations

import functools
from typing import TYPE_CHECKING, Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from byteps_tpu_torch.ops.backend import resolve_device
from byteps_tpu_torch.ops.segmented_lora import (
    check_slots,
    segmented_lora_delta,
)

if TYPE_CHECKING:
    from byteps_tpu_torch.models.gpt import GPTConfig

_COL_TARGETS = ("wq", "wk", "wv", "w1", "w3")
_ROW_TARGETS = ("wo", "w2")
ALL_TARGETS = _COL_TARGETS + _ROW_TARGETS


def _target_dims(cfg: "GPTConfig", name: str) -> Tuple[int, int]:
    d, ff = cfg.d_model, cfg.d_ff
    hd = cfg.n_heads * cfg.head_dim
    kv_hd = cfg.kv_heads * cfg.head_dim
    return {
        "wq": (d, hd), "wk": (d, kv_hd), "wv": (d, kv_hd),
        "wo": (hd, d), "w1": (d, ff), "w3": (d, ff), "w2": (ff, d),
    }[name]


def _check_targets(cfg: "GPTConfig",
                   targets: Sequence[str]) -> Tuple[str, ...]:
    targets = tuple(targets)
    if not targets:
        raise ValueError("LoRA needs at least one target projection")
    for t in targets:
        if t not in ALL_TARGETS:
            raise ValueError(f"unknown LoRA target {t!r} — expected a "
                             f"subset of {ALL_TARGETS}")
        if t == "w3" and cfg.mlp != "swiglu":
            raise ValueError("target 'w3' needs mlp='swiglu'")
    return targets


def lora_init(cfg: "GPTConfig", rank: int,
              targets: Sequence[str] = ("wq", "wv"),
              generator: Optional[torch.Generator] = None,
              device=None) -> Dict[str, Any]:
    """Adapter tree on ``device`` (the card unless told otherwise): per
    block and target ``a ~ N(0, 1/rank)`` drawn from ``generator`` and
    ``b = 0``, so the grafted model starts exactly at the frozen base.
    The draws differ from ``jax.random``'s; tests carry the reference's
    adapters over with ``adapters_from_numpy``."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1; got {rank}")
    targets = _check_targets(cfg, targets)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    blocks = []
    for _ in range(cfg.n_layers):
        blk = {}
        for t in targets:
            d_in, d_out = _target_dims(cfg, t)
            blk[t] = {
                "a": torch.randn((d_in, rank), generator=generator,
                                 device=dev) / rank ** 0.5,
                "b": torch.zeros((rank, d_out), device=dev),
            }
        blocks.append(blk)
    return {"blocks": blocks}


def _leaves(p) -> Dict[str, Any]:
    """A module's own leaves, or a plain dict's entries, by name (the
    same tensor objects: nothing is copied)."""
    if isinstance(p, nn.Module):
        return dict(p._parameters)
    return dict(p)


def graft_blocks(base_params, loras) -> Dict[str, Any]:
    """``base_params`` as a plain tree whose block ``li`` carries
    ``loras[li]`` under ``"lora"``. Every base leaf is shared by
    reference, so grafting many adapters onto one model costs only the
    adapters' own bytes."""
    out = _leaves(base_params)
    out.pop("blocks", None)
    blocks = []
    for bp, lr in zip(base_params["blocks"], loras):
        blk = _leaves(bp)
        blk["lora"] = lr
        blocks.append(blk)
    out["blocks"] = blocks
    return out


def graft_lora(base_params, adapters: Dict[str, Any],
               scale: float) -> Dict[str, Any]:
    """Frozen base + adapters → the tree the forward consumes: each
    block carries a ``"lora"`` sub-dict with ``scale`` folded into
    ``b``; base leaves shared by reference (:func:`graft_blocks`)."""
    return graft_blocks(base_params, [
        {t: {"a": ab["a"], "b": ab["b"] * scale} for t, ab in ad.items()}
        for ad in adapters["blocks"]])


@functools.lru_cache(maxsize=None)
def _zero_slots(rows: int, device: torch.device) -> torch.Tensor:
    """Every row on slot 0, checked once per (rows, device)."""
    slots = torch.zeros(rows, dtype=torch.int32, device=device)
    check_slots(slots, 1)
    return slots


def lora_delta(x: torch.Tensor, p, name: str,
               tp_axis=None) -> Optional[torch.Tensor]:
    """``(x @ a) @ b`` of target ``name`` of the grafted block ``p``
    (scale already in ``b``), in x's dtype; None when the block carries
    no adapter for it. ``x`` is ``(B, T, d_in)``: each of the B rows is a
    row of the segmented product on the one slot. For a row-parallel
    target (``wo``, ``w2``) with a live ``tp_axis`` (a mesh ``Axis``),
    ``x`` and ``a`` are this rank's share of ``d_in`` and the thin
    intermediate is summed over tp (the reference's ``:176``); the base
    matmul's own sum runs apart from it."""
    lr = p.get("lora")
    if lr is None or name not in lr:
        return None
    a, b = lr[name]["a"], lr[name]["b"]
    if x.is_cuda and torch.is_grad_enabled() and (
            x.requires_grad or a.requires_grad or b.requires_grad):
        raise NotImplementedError(
            "the LoRA delta is forward-only on the card: its kernel has "
            "no backward yet (LoRA training is a later slice)")
    x3 = x.reshape(-1, x.shape[-2], x.shape[-1])
    out = segmented_lora_delta(x3, a.float()[None], b.float()[None],
                               _zero_slots(x3.shape[0], x.device),
                               row_parallel=name in _ROW_TARGETS,
                               tp_axis=tp_axis)
    return out.reshape(*x.shape[:-1], out.shape[-1])


def lora_logical_specs(target: str) -> Dict[str, Tuple]:
    """The logical axes of one target's ``a`` and ``b``: a column target
    splits ``b``'s output dim, a row target ``a``'s input dim (the
    reference's ``lora_param_specs``)."""
    if target in _COL_TARGETS:
        return {"a": ("embed", None), "b": (None, "heads")}
    return {"a": ("heads", None), "b": (None, "embed")}


def lora_param_specs(cfg: "GPTConfig", tp_axis: Optional[str], rank: int,
                     targets: Sequence[str] = ("wq", "wv")
                     ) -> Dict[str, Any]:
    """Specs mirroring :func:`lora_init`'s tree over a mesh's ``tp_axis``
    (an axis name, as the other ``*_param_specs`` take): column-parallel
    targets split ``b``'s output dim (no extra collective), row-parallel
    targets ``a``'s input dim (the ``(B, S, r)`` intermediate is summed
    in the forward). ``rank`` is the reference's argument; no spec
    depends on it."""
    targets = _check_targets(cfg, targets)
    return adapter_specs({"blocks": [dict.fromkeys(targets)]
                          * cfg.n_layers}, tp_axis)


def adapter_specs(adapters: Dict[str, Any], tp_axis: Optional[str]
                  ) -> Dict[str, Any]:
    """The specs of an adapter tree's own layers and targets over
    ``tp_axis`` (:func:`lora_param_specs`'s, target by target)."""
    from byteps_tpu_torch.parallel.partitioner import (resolve_specs,
                                                       rules_from_axes)

    tree = {"blocks": [{t: lora_logical_specs(t) for t in blk}
                       for blk in adapters["blocks"]]}
    return resolve_specs(tree, rules_from_axes(tp_axis=tp_axis))


def lora_rank(adapters: Dict[str, Any]) -> int:
    """The adapter tree's rank (every target shares one)."""
    blk = adapters["blocks"][0]
    first = next(iter(blk.values()))
    return int(first["a"].shape[-1])


def lora_pool_slabs(adapters: Dict[str, Any], cfg: "GPTConfig",
                    rank_bucket: int, scale: float,
                    targets: Sequence[str]) -> Dict[str, Any]:
    """Pool-loadable slabs of ONE adapter, on the adapter's device: per
    target ``a (n_layers, d_in, rank_bucket)`` and ``b (n_layers,
    rank_bucket, d_out)`` float32, rank-padded with zeros (a zero A
    column times a zero B row adds exactly 0.0) and with ``scale``
    multiplied into ``b`` in the adapter's own dtype first — the
    arithmetic :func:`graft_lora` does — then upcast. The adapter must
    carry every requested target."""
    targets = _check_targets(cfg, targets)
    r = lora_rank(adapters)
    if r > rank_bucket:
        raise ValueError(f"adapter rank {r} exceeds the pool's rank bucket "
                         f"{rank_bucket}")
    out: Dict[str, Any] = {}
    for t in targets:
        d_in, d_out = _target_dims(cfg, t)
        a_l, b_l = [], []
        for blk in adapters["blocks"]:
            if t not in blk:
                raise ValueError(
                    f"adapter is missing pool target {t!r} — the pool's "
                    "targets must be a subset of every registered "
                    "adapter's")
            ab = blk[t]
            dev = ab["a"].device
            a = torch.zeros((d_in, rank_bucket), device=dev)
            a[:, :r] = ab["a"].float()
            b = torch.zeros((rank_bucket, d_out), device=dev)
            b[:r] = (ab["b"] * scale).float()
            a_l.append(a)
            b_l.append(b)
        out[t] = {"a": torch.stack(a_l), "b": torch.stack(b_l)}
    return out


@torch.no_grad()
def merge_lora(base_params, adapters: Dict[str, Any],
               scale: float) -> Dict[str, Any]:
    """Fold the adapters into plain weights, ``w + scale * a @ b`` per
    target (in f32, back to the leaf's dtype): a plain tree that decodes
    without any LoRA arm. Untouched leaves are shared by reference."""
    out = _leaves(base_params)
    out.pop("blocks", None)
    blocks = []
    for bp, ad in zip(base_params["blocks"], adapters["blocks"]):
        blk = _leaves(bp)
        for t, ab in ad.items():
            w = blk[t]
            blk[t] = (w.float() + scale * ab["a"].float() @ ab["b"].float()
                      ).to(w.dtype)
        blocks.append(blk)
    out["blocks"] = blocks
    return out
