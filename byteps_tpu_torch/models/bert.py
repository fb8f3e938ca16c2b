"""BERT-style bidirectional encoder with the masked-LM loss.

Counterpart of ``byteps_tpu/models/bert.py``: BASELINE config 3's model
("BERT-base pretrain with onebit gradient compression"). The blocks are
the GPT family's (``models/gpt.py`` ``transformer_block``) with
``causal=False``, so tp's column/row-parallel projections and the sp
ring (non-causal) carry over; BERT adds token-type embeddings, an
embedding layernorm and the MLM head (dense, gelu, layernorm, then the
readout tied to ``wte`` plus ``mlm_bias``). Leaf names and layouts are
the reference's (``x @ W``, W ``(d_in, d_out)``, f32 master weights cast
to the activation dtype per op), held in a
:class:`~byteps_tpu_torch.models.gpt.ParamTree`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from byteps_tpu_torch.models.gpt import (
    ParamTree,
    _layernorm,
    _nll,
    _positions,
    block_init,
    block_logical_specs,
    head_dot,
    transformer_block,
)
from byteps_tpu_torch.ops.backend import resolve_device
from byteps_tpu_torch.ops.chunked_ce import chunked_ce_nll
from byteps_tpu_torch.parallel.remat import maybe_remat
from byteps_tpu_torch.parallel.tp import maybe_psum


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30528
    max_seq: int = 512
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    type_vocab: int = 2
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def tiny(cls) -> "BertConfig":
        return cls(vocab_size=256, max_seq=64, d_model=64, n_heads=4,
                   n_layers=2, d_ff=128)

    @classmethod
    def base(cls) -> "BertConfig":
        return cls(dtype=torch.bfloat16)


def bert_init(cfg: BertConfig, generator: Optional[torch.Generator] = None,
              device=None) -> ParamTree:
    """Random parameters for ``cfg`` on ``device`` (the card unless told
    otherwise) from ``generator`` (default: seed 0 on that device):
    N(0, 0.02²) weights, unit gains, zero biases. The draws differ from
    ``jax.random``'s; tests carry the reference's weights over with
    ``models.convert.tree_from_numpy``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d = cfg.d_model

    def dense(*shape):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * 0.02

    def const(n, v):
        return torch.full((n,), v, dtype=torch.float32, device=dev)

    tree = {
        "wte": dense(cfg.vocab_size, d),
        "wpe": dense(cfg.max_seq, d),
        "wtype": dense(cfg.type_vocab, d),
        "emb_ln_g": const(d, 1.0), "emb_ln_b": const(d, 0.0),
        "blocks": [block_init(generator, d, cfg.d_ff,
                              cfg.n_heads * cfg.head_dim, cfg.n_layers,
                              device=dev)
                   for _ in range(cfg.n_layers)],
        # MLM head: dense + LN, readout tied to wte (BERT's shape)
        "mlm_w": dense(d, d), "mlm_b": const(d, 0.0),
        "mlm_ln_g": const(d, 1.0), "mlm_ln_b": const(d, 0.0),
        "mlm_bias": const(cfg.vocab_size, 0.0),
    }
    return ParamTree(cfg, tree)


def bert_logical_specs(cfg: BertConfig) -> Dict[str, Any]:
    return {
        "wte": ("vocab", "embed"), "wpe": (None, "embed"),
        "wtype": (None, "embed"),
        "emb_ln_g": ("embed",), "emb_ln_b": ("embed",),
        "blocks": [block_logical_specs() for _ in range(cfg.n_layers)],
        "mlm_w": ("embed", "embed"), "mlm_b": ("embed",),
        "mlm_ln_g": ("embed",), "mlm_ln_b": ("embed",),
        "mlm_bias": ("vocab",),
    }


def bert_param_specs(cfg: BertConfig, tp_axis: Optional[str]
                     ) -> Dict[str, Any]:
    from byteps_tpu_torch.parallel.partitioner import (resolve_specs,
                                                       rules_from_axes)
    return resolve_specs(bert_logical_specs(cfg),
                         rules_from_axes(tp_axis=tp_axis))


def bert_hidden(params, tokens: torch.Tensor, cfg: BertConfig,
                type_ids: Optional[torch.Tensor] = None, tp_axis=None,
                sp_axis=None, remat: bool = False) -> torch.Tensor:
    """Embeddings → blocks → the MLM dense + layernorm, stopping before
    the tied vocab readout: the trunk of :func:`bert_forward` and of the
    fused readout + CE in :func:`bert_mlm_loss`. ``tokens`` is this
    rank's (B, S_local) block at its sp offset. Returns the pre-readout
    hidden in the activation dtype."""
    pos = _positions(tokens.shape[1], sp_axis, "contiguous", tokens.device)
    x = params["wte"][tokens] + params["wpe"][pos]
    if type_ids is not None:
        x = x + params["wtype"][type_ids]
    x = _layernorm(x.to(cfg.dtype), params["emb_ln_g"], params["emb_ln_b"])

    def apply_block(x, p):
        return transformer_block(x, p, cfg.head_dim, tp_axis, sp_axis,
                                 causal=False)

    apply_block = maybe_remat(apply_block, remat)
    for p in params["blocks"]:
        x = apply_block(x, p)
    # the MLM head: activation-dtype operands, f32 accumulation
    h = F.gelu(head_dot(x, params["mlm_w"]) + params["mlm_b"],
               approximate="tanh")
    h = _layernorm(h, params["mlm_ln_g"], params["mlm_ln_b"])
    return h.to(x.dtype)


def bert_forward(params, tokens: torch.Tensor, cfg: BertConfig,
                 type_ids: Optional[torch.Tensor] = None, tp_axis=None,
                 sp_axis=None, remat: bool = False) -> torch.Tensor:
    """(B, S_local) tokens → f32 MLM logits (B, S_local, V)."""
    h = bert_hidden(params, tokens, cfg, type_ids=type_ids, tp_axis=tp_axis,
                    sp_axis=sp_axis, remat=remat)
    return head_dot(h, params["wte"].T) + params["mlm_bias"]


def bert_mlm_loss(params, tokens: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor, cfg: BertConfig, dp_axis=None,
                  tp_axis=None, sp_axis=None, remat: bool = False,
                  chunked_ce=True) -> torch.Tensor:
    """Masked-LM cross-entropy over the ``mask`` positions only.

    ``tokens`` are the corrupted inputs, ``targets`` the originals,
    ``mask`` a {0, 1} (B, S) tensor of the predicted positions. The
    masked NLL's sum and the mask's count are summed over ``dp_axis``
    and ``sp_axis`` (forward only: each rank's gradient is its own
    positions' share) before the division, so the loss is the global
    masked mean on every rank, replicated over tp by construction.
    ``chunked_ce``: True fuses the tied readout + ``mlm_bias`` + CE
    (``ops/chunked_ce.py``), ``"vocab_parallel"`` also splits its vocab
    over tp, False is the dense chain."""
    if chunked_ce:
        h = bert_hidden(params, tokens, cfg, tp_axis=tp_axis,
                        sp_axis=sp_axis, remat=remat)
        nll = chunked_ce_nll(
            h, params["wte"].T.float(), targets, bias=params["mlm_bias"],
            tp_axis=tp_axis if chunked_ce == "vocab_parallel" else None)
    else:
        nll = _nll(bert_forward(params, tokens, cfg, tp_axis=tp_axis,
                                sp_axis=sp_axis, remat=remat), targets)
    m = mask.float()
    num = (nll * m).sum()
    den = m.sum()
    for axis in (dp_axis, sp_axis):
        num = maybe_psum(num, axis)
        den = maybe_psum(den, axis)
    return num / torch.clamp(den, min=1.0)

