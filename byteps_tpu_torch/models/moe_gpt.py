"""MoE GPT: dense attention + a Switch-style MoE FFN, experts over ep.

Counterpart of ``byteps_tpu/models/moe_gpt.py``, the sparse-FFN sibling
of the dense GPT (``models/gpt.py``, whose attention, norms, embeddings
and readout it shares). Each block's MLP is
:func:`~byteps_tpu_torch.parallel.moe.moe_ffn`: top-1 capacity routing
(top-2 with ``router_topk=2``), the experts' weights stacked on a
leading expert axis that the ep axis shards, token slots exchanged with
their expert's owner over ep. The Switch load-balancing loss is averaged
over the layers and added with ``aux_coef``. The parameters live in the
dense family's :class:`~byteps_tpu_torch.models.gpt.GPT` module, each
block's expert leaves under a nested ``"moe"`` block.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from byteps_tpu_torch.models.gpt import (
    GPT,
    GPTConfig,
    _attention,
    _embed,
    _positions,
    _readout_nll,
    block_init,
    block_logical_specs,
    resolve_norm,
    resolve_rope,
)
from byteps_tpu_torch.ops.backend import resolve_device
from byteps_tpu_torch.parallel.moe import moe_ffn, moe_init, moe_logical_specs
from byteps_tpu_torch.parallel.remat import maybe_remat
from byteps_tpu_torch.parallel.tp import pmean

_DENSE_FFN = ("w1", "b1", "w2", "b2", "w3", "b3")


@dataclasses.dataclass(frozen=True)
class MoEGPTConfig(GPTConfig):
    n_experts: int = 8
    capacity_factor: float = 1.25
    aux_coef: float = 0.01
    router_topk: int = 1  # 1 = Switch, 2 = GShard-style top-2

    @classmethod
    def tiny(cls) -> "MoEGPTConfig":
        return cls(vocab_size=256, max_seq=64, d_model=64, n_heads=4,
                   n_layers=2, d_ff=128, n_experts=4,
                   capacity_factor=4.0)


def moe_block_init(generator: torch.Generator, cfg: MoEGPTConfig,
                   device=None) -> Dict[str, Any]:
    """The attention half of a dense block plus the expert-stacked FFN
    (``cfg.mlp="swiglu"``: gated experts) under ``"moe"``."""
    dev = resolve_device(device)
    b = block_init(generator, cfg.d_model, cfg.d_ff,
                   cfg.n_heads * cfg.head_dim, cfg.n_layers,
                   kv_hd=cfg.kv_heads * cfg.head_dim, mlp=cfg.mlp,
                   use_bias=cfg.use_bias, norm=cfg.norm, device=dev)
    for k in _DENSE_FFN:
        b.pop(k, None)
    b["moe"] = moe_init(generator, cfg.d_model, cfg.d_ff, cfg.n_experts,
                        mlp=cfg.mlp, device=dev)
    return b


def moe_gpt_init(cfg: MoEGPTConfig,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> GPT:
    """Random parameters for ``cfg`` on ``device`` (the card unless told
    otherwise) from ``generator`` (default: seed 0 on that device), as a
    :class:`GPT`. The draws differ from ``jax.random``'s; tests carry the
    reference's own weights over with ``params_from_numpy``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d = cfg.d_model

    def dense(*shape):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * 0.02

    leaves = {"wte": dense(cfg.vocab_size, d),
              "lnf_g": torch.ones(d, dtype=torch.float32, device=dev)}
    if cfg.pos_embedding == "learned":
        leaves["wpe"] = dense(cfg.max_seq, d)
    if cfg.norm == "layernorm":
        leaves["lnf_b"] = torch.zeros(d, dtype=torch.float32, device=dev)
    if not cfg.tied_readout:
        leaves["lm_head"] = dense(d, cfg.vocab_size)
    blocks = [moe_block_init(generator, cfg, device=dev)
              for _ in range(cfg.n_layers)]
    return GPT(cfg, leaves, blocks)


def moe_block_logical_specs(use_bias: bool = True, norm: str = "layernorm",
                            mlp: str = "gelu") -> Dict[str, Any]:
    """Logical axes of one MoE block: the dense block's without its FFN,
    and :func:`~byteps_tpu_torch.parallel.moe.moe_logical_specs` under
    ``"moe"``."""
    s = block_logical_specs(mlp=mlp, use_bias=use_bias, norm=norm)
    for k in _DENSE_FFN:
        s.pop(k, None)
    s["moe"] = moe_logical_specs(mlp=mlp)
    return s


def moe_block_specs(ep_axis: Optional[str], tp_axis: Optional[str] = None,
                    use_bias: bool = True, norm: str = "layernorm",
                    mlp: str = "gelu") -> Dict[str, Any]:
    from byteps_tpu_torch.parallel.partitioner import (resolve_specs,
                                                       rules_from_axes)
    return resolve_specs(
        moe_block_logical_specs(use_bias=use_bias, norm=norm, mlp=mlp),
        rules_from_axes(tp_axis=tp_axis, ep_axis=ep_axis))


def moe_gpt_logical_specs(cfg: MoEGPTConfig) -> Dict[str, Any]:
    return {
        "wte": ("vocab", "embed"), "lnf_g": ("embed",),
        **({"wpe": (None, "embed")} if cfg.pos_embedding == "learned"
           else {}),
        **({"lnf_b": ("embed",)} if cfg.norm == "layernorm" else {}),
        **({} if cfg.tied_readout else {"lm_head": ("embed", "vocab")}),
        "blocks": [moe_block_logical_specs(use_bias=cfg.use_bias,
                                           norm=cfg.norm, mlp=cfg.mlp)
                   for _ in range(cfg.n_layers)],
    }


def moe_gpt_param_specs(cfg: MoEGPTConfig, ep_axis: Optional[str],
                        tp_axis: Optional[str] = None) -> Dict[str, Any]:
    from byteps_tpu_torch.parallel.partitioner import (resolve_specs,
                                                       rules_from_axes)
    return resolve_specs(moe_gpt_logical_specs(cfg),
                         rules_from_axes(tp_axis=tp_axis, ep_axis=ep_axis))


def moe_transformer_block(x, p, cfg: MoEGPTConfig, ep_axis=None,
                          tp_axis=None, sp_axis=None,
                          seq_layout: str = "contiguous",
                          pos: Optional[torch.Tensor] = None):
    """Pre-norm attention + MoE FFN; returns ``(x, aux)``."""
    norm_fn, norm_eps = resolve_norm(cfg)
    x = x + _attention(norm_fn(x, p["ln1_g"], p.get("ln1_b"), norm_eps), p,
                       cfg.head_dim, tp_axis, sp_axis, seq_layout=seq_layout,
                       rope_base=resolve_rope(cfg), use_bias=cfg.use_bias,
                       pos=pos)
    m, aux = moe_ffn(norm_fn(x, p["ln2_g"], p.get("ln2_b"), norm_eps),
                     p["moe"], cfg.capacity_factor, ep_axis,
                     router_topk=cfg.router_topk, tp_axis=tp_axis)
    return x + m, aux


def moe_gpt_loss(params, tokens: torch.Tensor, targets: torch.Tensor,
                 cfg: MoEGPTConfig, ep_axis=None, tp_axis=None,
                 sp_axis=None, remat: bool = False,
                 seq_layout: str = "contiguous",
                 chunked_ce=True) -> torch.Tensor:
    """This rank's next-token loss plus the Switch aux term (the mean over
    this rank's tokens, then the mean over ``sp_axis``; the dp and ep
    means are the train step's)."""
    pos = _positions(tokens.shape[1], sp_axis, seq_layout, tokens.device)
    x = _embed(params, tokens, cfg, pos=pos)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def apply_block(x, p):
        return moe_transformer_block(x, p, cfg, ep_axis, tp_axis, sp_axis,
                                     seq_layout, pos=pos)

    apply_block = maybe_remat(apply_block, remat)
    for p in params["blocks"]:
        x, aux = apply_block(x, p)
        aux_total = aux_total + aux
    nll = _readout_nll(params, x, targets, *resolve_norm(cfg),
                       tp_axis=tp_axis, chunked=chunked_ce)
    loss = nll.mean() + cfg.aux_coef * aux_total / cfg.n_layers
    return pmean(loss, sp_axis)


def moe_gpt_pp_loss(params, tokens: torch.Tensor, targets: torch.Tensor,
                    cfg: MoEGPTConfig, pp_axis, n_micro: int, ep_axis=None,
                    tp_axis=None, sp_axis=None, remat: bool = False,
                    seq_layout: str = "contiguous",
                    chunked_ce=True) -> torch.Tensor:
    """Pipelined MoE loss: ``params["blocks"]`` is this stage's stacked
    MoE slab. As ``gpt_pp_loss``, the nll is the last stage's (0.0
    elsewhere); every stage adds its own layers' aux over its M
    microbatches scaled by ``aux_coef / (n_layers · n_micro)`` (each
    (layer, microbatch) counted once over the stages), and the WHOLE
    scalar is averaged over sp: averaging the nll alone would leave the
    aux term's sp-summed gradients unscaled, multiplying the
    load-balancing gradient by sp. Routing is per microbatch (the
    capacity from the microbatch's tokens)."""
    from byteps_tpu_torch.parallel.pipeline import (is_last_stage,
                                                    pipeline_apply)

    B, S_loc = tokens.shape
    if B % n_micro != 0:
        raise ValueError(f"local batch {B} not divisible by {n_micro} "
                         "microbatches")
    pos = _positions(S_loc, sp_axis, seq_layout, tokens.device)
    x = _embed(params, tokens, cfg, pos=pos)
    x_mb = x.reshape(n_micro, B // n_micro, S_loc, x.shape[-1])

    def blk(h, p):
        return moe_transformer_block(h, p, cfg, ep_axis, tp_axis, sp_axis,
                                     seq_layout, pos=pos)

    y_mb, aux_total = pipeline_apply(x_mb, params["blocks"], blk, pp_axis,
                                     remat=remat, has_aux=True)
    if is_last_stage(pp_axis):
        y = y_mb.reshape(B, S_loc, -1)
        nll = _readout_nll(params, y, targets, *resolve_norm(cfg),
                           tp_axis=tp_axis, chunked=chunked_ce).mean()
    else:
        # zeros: the value 0.0 and the way into the pipeline's backward
        nll = y_mb.float().sum()
    aux_term = cfg.aux_coef * aux_total / (cfg.n_layers * n_micro)
    return pmean(nll + aux_term, sp_axis)
