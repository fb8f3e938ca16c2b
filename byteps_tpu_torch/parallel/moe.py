"""Expert parallelism over an ep mesh axis: the Mixture-of-Experts FFN.

Counterpart of ``byteps_tpu/parallel/moe.py``: top-1 (Switch) or top-2
(GShard) gating with a static per-expert capacity (tokens past it are
dropped; their residual path passes them on), dispatch and combine as
products with a one-hot ``(token, expert, slot)`` tensor, and the
experts' weights stacked on a leading expert axis that the ep axis
shards. Each rank routes its own tokens to all E experts; the slots of
the experts another rank owns travel there and back in two exchanges
over the ep group (:class:`AllToAll`: one ``all_to_all_single`` each,
carried as bytes, since gloo's all-to-all takes no 16-bit type; its
backward is the same exchange of the gradients). The dispatch, expert
and combine products are plain ``torch.einsum`` (the reference's are
XLA einsums, outside any Pallas kernel). With a tp axis each expert's
ff dim is Megatron-sharded: the slots enter through ``copy_to_tp`` and
the row-parallel ``w2`` product is summed over tp before its bias.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from byteps_tpu_torch.ops.backend import resolve_device
from byteps_tpu_torch.parallel.mesh import collectives
from byteps_tpu_torch.parallel.ring_attention import _wire
from byteps_tpu_torch.parallel.tp import copy_to_tp, maybe_psum


def topk_dispatch(gate_logits: torch.Tensor, capacity: int, k: int = 1):
    """Top-k routing tensors from ``(T, E)`` gate logits (k=1: Switch;
    k=2: GShard: second choices take slots after first choices, and the
    two gates renormalize to sum 1 a token).

    Returns ``(dispatch, combine, aux)``: ``dispatch`` the one-hot
    ``(T, E, C)`` f32 map of each kept (token, choice) to its (expert,
    slot), a slot being the token's rank among the expert's tokens of
    that choice (a cumulative sum in f32) after the slots of earlier
    choices; ``combine`` the same scaled by the choice's gate; ``aux``
    the Switch load-balancing loss on the FIRST choice (``E · Σ_e
    frac_tokens_e · mean_prob_e``). ``torch.argmax`` takes the first
    maximum, as ``jnp.argmax`` does."""
    T, E = gate_logits.shape
    if not 1 <= k <= E:
        raise ValueError(f"router top-k must satisfy 1 <= k <= n_experts "
                         f"({E}); got k={k}")
    probs = torch.softmax(gate_logits.float(), dim=-1)
    remaining = probs
    onehots, gates = [], []
    for _ in range(k):
        expert = torch.argmax(remaining, dim=-1)
        oh = F.one_hot(expert, E).float()
        gates.append(torch.sum(probs * oh, dim=-1))
        onehots.append(oh)
        remaining = remaining * (1.0 - oh)
    if k > 1:
        # renormalize so each token's kept choices sum to 1 (GShard);
        # never at k=1, where it would make every weight exactly 1.0 and
        # silence the router's gradient through the task loss
        gate_sum = sum(gates)
        gates = [g / torch.clamp(gate_sum, min=1e-9) for g in gates]
    dev = gate_logits.device
    dispatch = torch.zeros((T, E, capacity), dtype=torch.float32, device=dev)
    combine = torch.zeros((T, E, capacity), dtype=torch.float32, device=dev)
    used = torch.zeros((E,), dtype=torch.float32, device=dev)
    for oh, gate in zip(onehots, gates):
        slot = (torch.cumsum(oh, dim=0) - 1.0) * oh + used[None, :] * oh
        kept = (slot < capacity) & (oh > 0)
        slot_oh = F.one_hot(
            torch.clamp(slot, 0, capacity - 1).sum(-1).long(),
            capacity).float()
        d = kept.float()[:, :, None] * slot_oh[:, None, :]
        dispatch = dispatch + d
        combine = combine + d * gate[:, None, None]
        used = used + oh.sum(0)
    frac = onehots[0].mean(0)
    aux = E * torch.sum(frac * probs.mean(0))
    return dispatch, combine, aux


def top1_dispatch(gate_logits: torch.Tensor, capacity: int):
    """Switch-style top-1 routing (see :func:`topk_dispatch`)."""
    return topk_dispatch(gate_logits, capacity, k=1)


def _exchange(x: torch.Tensor, axis) -> torch.Tensor:
    """``x (ep, ...)``: block i to index i of ``axis``; returns the blocks
    received, block j from index j."""
    out = torch.empty_like(x)
    dist.all_to_all_single(_wire(out.reshape(-1)), _wire(x.reshape(-1)),
                           group=axis.group)
    return out


class AllToAll(torch.autograd.Function):
    """The reference's ``lax.all_to_all(split_axis=0, concat_axis=0)``
    over the ep axis, forward and (the same exchange of the gradients)
    backward."""

    @staticmethod
    def forward(x, axis):
        collectives["ep_all_to_all_fwd"] += 1
        return _exchange(x.contiguous(), axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        collectives["ep_all_to_all_bwd"] += 1
        return _exchange(g.contiguous(), ctx.axis), None


def all_to_all(x: torch.Tensor, axis) -> torch.Tensor:
    """:class:`AllToAll` of ``x (ep, ...)`` over ``axis``."""
    return AllToAll.apply(x, axis)


def _gelu(h: torch.Tensor) -> torch.Tensor:
    return F.gelu(h, approximate="tanh")     # jax.nn.gelu's default


def moe_ffn(x: torch.Tensor, params, capacity_factor: float = 1.25,
            ep_axis=None, activation=_gelu, router_topk: int = 1,
            tp_axis=None, no_drop: bool = False):
    """MoE feed-forward over the trailing feature dim of ``x (..., d)``.

    ``params``: the gate ``wg (d, E)``; expert-stacked ``w1 (E_loc, d,
    ff)``, ``b1 (E_loc, ff)``, ``w2 (E_loc, ff, d)``, ``b2 (E_loc, d)``
    (and the gated experts' ``w3``/``b3``): with ``ep_axis`` this rank's
    experts, without it all of them; with ``tp_axis`` each expert's ff
    dim is this rank's Megatron shard. The capacity is ``max(1,
    int(capacity_factor · k · T / E))`` with T this call's own tokens, or
    T (``no_drop``: no token can be dropped). Routing runs in f32, the
    expert products and the exchanges in ``x``'s dtype.

    Returns ``(y, aux)``, ``y`` shaped like ``x`` (a dropped token's is
    zero: add the residual outside) and ``aux`` the f32 load-balancing
    loss of this rank's tokens."""
    ep = ep_axis.size if ep_axis is not None else 1
    e_loc = params["w1"].shape[0]
    E = e_loc * ep
    lead = x.shape[:-1]
    d = x.shape[-1]
    T = 1
    for n in lead:
        T *= n
    xt = x.reshape(T, d)
    gate_logits = xt.float() @ params["wg"].float()
    cap = (T if no_drop
           else max(1, int(capacity_factor * router_topk * T / E)))
    dispatch, combine, aux = topk_dispatch(gate_logits, cap, k=router_topk)
    slots = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), xt)
    if ep > 1:
        # each expert's slots to its owner: (ep, E_loc, cap, d), block i
        # to index i; received, axis 0 is the source rank
        slots = all_to_all(slots.reshape(ep, e_loc, cap, d), ep_axis)
        slots = slots.transpose(0, 1).reshape(e_loc, ep * cap, d)
    slots = copy_to_tp(slots, tp_axis)
    h = torch.einsum("ecd,edf->ecf", slots, params["w1"].to(x.dtype))
    h = h + params["b1"][:, None, :].to(x.dtype)
    if "w3" in params:
        # gated experts: silu(slots·w1) ∘ (slots·w3)
        g = torch.einsum("ecd,edf->ecf", slots, params["w3"].to(x.dtype))
        g = g + params["b3"][:, None, :].to(x.dtype)
        h = F.silu(h) * g
    else:
        h = activation(h)
    y = torch.einsum("ecf,efd->ecd", h, params["w2"].to(x.dtype))
    y = maybe_psum(y, tp_axis)
    y = y + params["b2"][:, None, :].to(x.dtype)
    if ep > 1:
        y = y.reshape(e_loc, ep, cap, d).transpose(0, 1)
        y = all_to_all(y, ep_axis)
        # axis 0 is the owner: global expert e = owner · E_loc + local
        y = y.reshape(E, cap, d)
    out = torch.einsum("tec,ecd->td", combine.to(x.dtype), y)
    return out.reshape(*lead, d).to(x.dtype), aux.float()


def moe_init(generator: torch.Generator, d: int, ff: int, n_experts: int,
             std: float = 0.02, mlp: str = "gelu", device=None):
    """Expert-stacked MoE FFN leaves drawn from ``generator`` on
    ``device`` (the card unless told otherwise): N(0, std²) ``wg``,
    ``w1``, ``w2`` (and ``w3`` for ``mlp="swiglu"``, the gated
    experts), zero biases. The draws differ from ``jax.random``'s."""
    if mlp not in ("gelu", "swiglu"):
        raise ValueError(f"unknown mlp {mlp!r} — expected 'gelu' or "
                         "'swiglu'")
    dev = resolve_device(device)

    def dense(*shape):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * std

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    p = {"wg": dense(d, n_experts), "w1": dense(n_experts, d, ff),
         "b1": zeros(n_experts, ff), "w2": dense(n_experts, ff, d),
         "b2": zeros(n_experts, d)}
    if mlp == "swiglu":
        p["w3"] = dense(n_experts, d, ff)
        p["b3"] = zeros(n_experts, ff)
    return p


def moe_logical_specs(mlp: str = "gelu"):
    """Logical axes of :func:`moe_init`'s leaves: experts over the expert
    axis, each expert's ff dim Megatron column/row over mlp."""
    return {
        "wg": (None, None),
        "w1": ("expert", "embed", "mlp"), "b1": ("expert", "mlp"),
        "w2": ("expert", "mlp", "embed"), "b2": ("expert",),
        **({"w3": ("expert", "embed", "mlp"), "b3": ("expert", "mlp")}
           if mlp == "swiglu" else {}),
    }


def moe_specs(ep_axis: Optional[str], tp_axis: Optional[str] = None,
              mlp: str = "gelu"):
    """Specs of :func:`moe_init`'s leaves: experts over ``ep_axis``, each
    expert's ff dim over ``tp_axis``."""
    from byteps_tpu_torch.parallel.partitioner import (resolve_specs,
                                                       rules_from_axes)
    return resolve_specs(moe_logical_specs(mlp),
                         rules_from_axes(tp_axis=tp_axis, ep_axis=ep_axis))
