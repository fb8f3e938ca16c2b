"""GPT-style decoder-only transformer, the flagship model, in PyTorch.

Counterpart of ``byteps_tpu/models/gpt.py``. The parameters keep the
reference's leaf names and layouts — ``x @ W`` with W stored
``(d_in, d_out)``, f32 master weights cast to the activation dtype per
op — so a reference tree converts leaf for leaf (``models/convert.py``).
They live in a :class:`GPT` ``nn.Module`` that also answers
``params["wq"]``, ``"w3" in p`` and ``p.get("ln1_b")``, so the
functional code below reads like the reference and runs on the module or
on a plain dict alike.

One forward serves every parallel layout, as the reference's does: with
no axes it is the one-rank model; with a tp axis (a
:class:`~byteps_tpu_torch.parallel.mesh.Axis`) each rank holds its
Megatron shards (:func:`gpt_logical_specs`: q/k/v and w1/w3 split on
their output dim, wo and w2 on their input dim) and ``parallel/tp.py``
sums the row-parallel products; with an sp axis each rank holds a block
of the sequence at its global positions (contiguous, or the zigzag
layout) and attention runs the ring of ``parallel/ring_attention.py``.

Leaves are built frozen (``requires_grad=False``), as serving holds
them; the training step (``models/train.py``) turns them trainable.
Attention goes through the flash kernels on CUDA, the plain versions on
CPU. A grafted block (``models/lora.py``) adds its LoRA delta beside
each targeted matmul (:func:`with_lora`). The readout keeps f32 logits
from activation-dtype operands (:class:`HeadDot`); :func:`gpt_loss`
reaches it through the fused readout + cross-entropy of
``ops/chunked_ce.py`` by default, its vocab split over tp on request.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from byteps_tpu_torch.models.lora import lora_delta
from byteps_tpu_torch.ops.backend import resolve_device
from byteps_tpu_torch.ops.chunked_ce import chunked_ce_nll, f32_dot
from byteps_tpu_torch.parallel.remat import maybe_remat
from byteps_tpu_torch.parallel.ring_attention import (
    ring_attention,
    zigzag_local_positions,
    zigzag_ring_attention,
)
from byteps_tpu_torch.parallel.tp import (
    col_parallel_matmul,
    copy_to_tp,
    pmean,
    row_parallel_matmul,
)


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304
    max_seq: int = 1024
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    dtype: torch.dtype = torch.float32
    # "learned" = GPT-2 wpe table; "rope" = rotary embeddings on q/k
    pos_embedding: str = "learned"
    rope_base: float = 10000.0
    # grouped-query attention: k/v carry n_kv_heads heads (None = MHA)
    n_kv_heads: Any = None
    # "gelu" = GPT-2 2-matrix MLP; "swiglu" = (silu(x·w1) ∘ (x·w3)) · w2
    mlp: str = "gelu"
    # "layernorm" (GPT-2) or "rmsnorm" (llama: no centering, no bias)
    norm: str = "layernorm"
    norm_eps: float = 1e-5
    # False = llama-style bias-free projections: no b* leaves
    use_bias: bool = True
    # True = weight-tied readout (h @ wte.T); False = separate lm_head
    tied_readout: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        kv = self.n_kv_heads if self.n_kv_heads is not None else self.n_heads
        if self.n_heads % kv != 0:
            raise ValueError(
                f"n_heads ({self.n_heads}) must be a multiple of "
                f"n_kv_heads ({kv})")
        return kv

    @classmethod
    def tiny(cls) -> "GPTConfig":
        """Unit-test size."""
        return cls(vocab_size=256, max_seq=64, d_model=64, n_heads=4,
                   n_layers=2, d_ff=128)

    @classmethod
    def gpt2_medium(cls) -> "GPTConfig":
        return cls(vocab_size=50304, max_seq=1024, d_model=1024,
                   n_heads=16, n_layers=24, d_ff=4096, dtype=torch.bfloat16)

    @classmethod
    def llama(cls, **kw) -> "GPTConfig":
        """The llama-family option set (RoPE + GQA + SwiGLU + RMSNorm +
        untied readout); size fields via ``**kw``."""
        defaults = dict(pos_embedding="rope", mlp="swiglu", norm="rmsnorm",
                        tied_readout=False, use_bias=False)
        defaults.update(kw)
        return cls(**defaults)


class _Leaves(nn.Module):
    """A module whose parameters are addressed by the reference's leaf
    names: ``p["wq"]``, ``"w3" in p``, ``p.get("ln1_b")``; a nested dict
    of leaves (an MoE block's ``"moe"``) becomes a :class:`Block` under
    its key."""

    def _add_leaves(self, leaves: Dict[str, Any]) -> None:
        for name, t in leaves.items():
            if isinstance(t, dict):
                self.add_module(name, Block(t))
            else:
                self.register_parameter(
                    name, nn.Parameter(t, requires_grad=False))

    def keys(self) -> List[str]:
        """The leaf and sub-tree names, leaves first."""
        return list(self._parameters) + list(self._modules)

    def __getitem__(self, name: str):
        if name in self._parameters or name in self._modules:
            return getattr(self, name)
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def get(self, name: str, default=None):
        return self[name] if name in self else default


class Block(_Leaves):
    """One transformer block's leaves (``block_init``'s names)."""

    def __init__(self, leaves: Dict[str, torch.Tensor]):
        super().__init__()
        self._add_leaves(leaves)


class GPT(_Leaves):
    """The parameters of one GPT-family model: top-level leaves (``wte``,
    ``lnf_g``, optional ``wpe``/``lnf_b``/``lm_head``) plus ``blocks``:
    an ``nn.ModuleList`` of :class:`Block`, one a layer, or, given a dict
    of stacked leaves, one :class:`Block` holding a pipeline stage's slab
    (``(layers, ...)`` each leaf, ``parallel.pipeline.stack_blocks``;
    :attr:`stacked`). ``forward(tokens)`` is :func:`gpt_forward`."""

    def __init__(self, cfg: GPTConfig, leaves: Dict[str, torch.Tensor],
                 blocks):
        super().__init__()
        self.cfg = cfg
        self._add_leaves(leaves)
        self.blocks = (Block(blocks) if isinstance(blocks, dict)
                       else nn.ModuleList(Block(b) for b in blocks))

    @property
    def stacked(self) -> bool:
        return isinstance(self.blocks, Block)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return gpt_forward(self, tokens, self.cfg)


def block_init(generator: torch.Generator, d: int, ff: int, hd: int,
               n_layers: int, kv_hd: Optional[int] = None,
               mlp: str = "gelu", use_bias: bool = True,
               norm: str = "layernorm",
               device: Optional[torch.device] = None
               ) -> Dict[str, torch.Tensor]:
    """One block's leaves, drawn from ``generator`` on ``device``:
    N(0, 0.02²) weights (wo/w2 scaled by 1/sqrt(2·n_layers)), unit norm
    gains, zero biases. ``kv_hd`` narrows k/v (GQA), ``mlp="swiglu"``
    adds ``w3``; absent options leave their leaves out entirely."""
    if mlp not in ("gelu", "swiglu"):
        raise ValueError(f"unknown mlp {mlp!r} — expected 'gelu' or "
                         "'swiglu'")
    dev = resolve_device(device)
    std = 0.02
    if kv_hd is None:
        kv_hd = hd

    def dense(*shape):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * std

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=dev)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=dev)

    p = {
        "ln1_g": ones(d),
        "wq": dense(d, hd),
        "wk": dense(d, kv_hd),
        "wv": dense(d, kv_hd),
        "wo": dense(hd, d) / (2 * n_layers) ** 0.5,
        "ln2_g": ones(d),
        "w1": dense(d, ff),
        "w2": dense(ff, d) / (2 * n_layers) ** 0.5,
    }
    if mlp == "swiglu":
        p["w3"] = dense(d, ff)
    if norm == "layernorm":
        p["ln1_b"] = zeros(d)
        p["ln2_b"] = zeros(d)
    if use_bias:
        p.update(bq=zeros(hd), bk=zeros(kv_hd), bv=zeros(kv_hd),
                 bo=zeros(d), b1=zeros(ff), b2=zeros(d))
        if mlp == "swiglu":
            p["b3"] = zeros(ff)
    return p


def gpt_init(cfg: GPTConfig, generator: Optional[torch.Generator] = None,
             device=None) -> GPT:
    """Random parameters for ``cfg`` on ``device`` (the card unless told
    otherwise), drawn from ``generator`` (default: seed 0 on that
    device). The draws differ from ``jax.random``'s; tests carry the
    reference's own weights over with ``params_from_numpy``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.head_dim
    kv_hd = cfg.kv_heads * cfg.head_dim
    std = 0.02

    def dense(*shape):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * std

    leaves = {"wte": dense(cfg.vocab_size, d),
              "lnf_g": torch.ones(d, dtype=torch.float32, device=dev)}
    blocks = [block_init(generator, d, ff, hd, cfg.n_layers, kv_hd=kv_hd,
                         mlp=cfg.mlp, use_bias=cfg.use_bias, norm=cfg.norm,
                         device=dev)
              for _ in range(cfg.n_layers)]
    if cfg.pos_embedding == "learned":
        leaves["wpe"] = dense(cfg.max_seq, d)
    if cfg.norm == "layernorm":
        leaves["lnf_b"] = torch.zeros(d, dtype=torch.float32, device=dev)
    if not cfg.tied_readout:
        leaves["lm_head"] = dense(d, cfg.vocab_size)
    return GPT(cfg, leaves, blocks)


def gpt_logical_specs(cfg: GPTConfig) -> Dict[str, Any]:
    """Logical-axis tree matching :func:`gpt_init`'s leaves: one tuple of
    logical names per dimension (``parallel/partitioner.py`` maps them
    onto mesh axes)."""
    return {
        "wte": ("vocab", "embed"), "lnf_g": ("embed",),
        **({"wpe": (None, "embed")} if cfg.pos_embedding == "learned"
           else {}),
        **({"lnf_b": ("embed",)} if cfg.norm == "layernorm" else {}),
        **({} if cfg.tied_readout else {"lm_head": ("embed", "vocab")}),
        "blocks": [block_logical_specs(cfg.mlp, use_bias=cfg.use_bias,
                                       norm=cfg.norm)
                   for _ in range(cfg.n_layers)],
    }


def gpt_param_specs(cfg: GPTConfig, tp_axis: Optional[str]) -> Dict[str, Any]:
    """Spec tree matching :func:`gpt_init`'s leaves: column-parallel
    weights (q/k/v, w1, w3) and their biases split their output dim over
    ``tp_axis``, row-parallel weights (wo, w2) their input dim; the rest
    is replicated."""
    from byteps_tpu_torch.parallel.partitioner import (resolve_specs,
                                                       rules_from_axes)
    return resolve_specs(gpt_logical_specs(cfg),
                         rules_from_axes(tp_axis=tp_axis))


def block_logical_specs(mlp: str = "gelu", use_bias: bool = True,
                        norm: str = "layernorm") -> Dict[str, Any]:
    """Logical-axis dict of one block: q/k/v and w1/w3 column-parallel
    (output dim heads/kv/mlp), wo and w2 row-parallel (input dim
    likewise), biases following their weight's output dim."""
    s = {
        "ln1_g": ("embed",),
        "wq": ("embed", "heads"), "wk": ("embed", "kv"),
        "wv": ("embed", "kv"),
        "wo": ("heads", "embed"), "ln2_g": ("embed",),
        "w1": ("embed", "mlp"), "w2": ("mlp", "embed"),
        **({"w3": ("embed", "mlp")} if mlp == "swiglu" else {}),
    }
    if norm == "layernorm":
        s["ln1_b"] = ("embed",)
        s["ln2_b"] = ("embed",)
    if use_bias:
        s.update({
            "bq": ("heads",), "bk": ("kv",), "bv": ("kv",),
            "bo": ("embed",),
            "b1": ("mlp",), "b2": ("embed",),
            **({"b3": ("mlp",)} if mlp == "swiglu" else {}),
        })
    return s


def block_specs(tp_axis, mlp: str = "gelu", use_bias: bool = True,
                norm: str = "layernorm") -> Dict[str, Any]:
    """Spec dict of one block (see :func:`gpt_param_specs`)."""
    from byteps_tpu_torch.parallel.partitioner import (resolve_specs,
                                                       rules_from_axes)
    return resolve_specs(block_logical_specs(mlp, use_bias, norm),
                         rules_from_axes(tp_axis=tp_axis))


def resolve_rope(cfg: GPTConfig) -> float:
    """Validate the position scheme; the rope base to thread to the
    blocks (0.0 = learned wpe, no rotation)."""
    if cfg.pos_embedding not in ("learned", "rope"):
        raise ValueError(f"unknown pos_embedding {cfg.pos_embedding!r} — "
                         "expected 'learned' or 'rope'")
    if cfg.pos_embedding == "rope":
        if not cfg.rope_base > 0.0:
            raise ValueError(f"rope_base must be > 0; got {cfg.rope_base}")
        return cfg.rope_base
    return 0.0


def _positions(S_loc: int, sp_axis, seq_layout: str,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """This rank's global sequence positions (layout-aware): they feed the
    learned ``wpe`` gather and the RoPE rotations."""
    live = sp_axis is not None and sp_axis.size > 1
    if seq_layout == "zigzag" and live:
        return zigzag_local_positions(S_loc, sp_axis, device=device)
    off = sp_axis.index * S_loc if live else 0
    return off + torch.arange(S_loc, device=device)


def rope_rotate(x: torch.Tensor, pos: torch.Tensor,
                base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding (half-split convention) of
    ``x (B, S, H, D)`` at global positions ``pos``: ``(S,)`` shared by
    the batch or ``(B, S)`` per row (the serve tier's packed decode)."""
    D = x.shape[-1]
    half = D // 2
    inv_freq = 1.0 / (base ** (torch.arange(half, dtype=torch.float32,
                                            device=x.device) / half))
    ang = pos.to(torch.float32)[..., None] * inv_freq    # (.., S, half)
    if pos.ndim == 2:
        cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    else:
        cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _layernorm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * g + b).to(x.dtype)


def _rmsnorm(x: torch.Tensor, g: torch.Tensor, b=None,
             eps: float = 1e-5) -> torch.Tensor:
    """Llama-style RMS norm; ``b`` must be absent (no norm-bias leaf)."""
    if b is not None:
        raise ValueError("rmsnorm trees carry no norm-bias leaf")
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * g).to(x.dtype)


_NORMS = {"layernorm": _layernorm, "rmsnorm": _rmsnorm}


def resolve_norm(cfg: GPTConfig):
    """Validate cfg.norm; the (norm_fn, eps) pair for blocks/readout."""
    if cfg.norm not in _NORMS:
        raise ValueError(f"unknown norm {cfg.norm!r} — expected one of "
                         f"{sorted(_NORMS)}")
    if not cfg.norm_eps > 0.0:
        raise ValueError(f"norm_eps must be > 0; got {cfg.norm_eps}")
    return _NORMS[cfg.norm], cfg.norm_eps


def _bias(p, name: str, x: torch.Tensor, use_bias: bool):
    """The projection bias in the activation dtype, or None."""
    return p[name].to(x.dtype) if use_bias else None


def with_lora(y, x, p, name: str, seg=None, tp_axis=None):
    """``y`` (the frozen ``x @ w`` of target ``name``) plus its LoRA
    addends: the grafted block's own (``p["lora"]``, through
    :func:`~byteps_tpu_torch.models.lora.lora_delta`, whose row-parallel
    targets sum their thin intermediate over ``tp_axis``) and, in the
    serve tier's packed decode, each row's pooled adapter (``seg(name,
    x)``, None for a target the pool does not carry)."""
    d = lora_delta(x, p, name, tp_axis)
    if d is not None:
        y = y + d
    if seg is not None:
        d = seg(name, x)
        if d is not None:
            y = y + d
    return y


def _attention(x, p, head_dim: int, tp_axis=None, sp_axis=None,
               seq_layout: str = "contiguous", rope_base: float = 0.0,
               use_bias: bool = True, pos: Optional[torch.Tensor] = None):
    """The attention branch on this rank's tp-local heads: q/k/v
    column-parallel from the tp copy of ``x``, RoPE at the global
    positions ``pos`` (default ``arange(S)``), the sp ring (contiguous or
    zigzag) or one rank's attention, and the row-parallel output summed
    over tp before its bias."""
    B, S = x.shape[:2]
    x = copy_to_tp(x, tp_axis)
    q = col_parallel_matmul(x, p["wq"].to(x.dtype), _bias(p, "bq", x, use_bias))
    k = col_parallel_matmul(x, p["wk"].to(x.dtype), _bias(p, "bk", x, use_bias))
    v = col_parallel_matmul(x, p["wv"].to(x.dtype), _bias(p, "bv", x, use_bias))
    q = with_lora(q, x, p, "wq")
    k = with_lora(k, x, p, "wk")
    v = with_lora(v, x, p, "wv")
    h_loc = q.shape[-1] // head_dim
    kv_loc = k.shape[-1] // head_dim
    if kv_loc == 0 or h_loc % kv_loc != 0:
        raise ValueError(
            f"invalid head split: {h_loc} query heads vs {kv_loc} kv heads "
            "— with GQA under tensor parallelism, n_kv_heads must be "
            "divisible by the tp axis size")
    q = q.reshape(B, S, h_loc, head_dim)
    k = k.reshape(B, S, kv_loc, head_dim)
    v = v.reshape(B, S, kv_loc, head_dim)
    if rope_base > 0.0:
        if pos is None:
            pos = torch.arange(S, device=x.device)
        q = rope_rotate(q, pos, rope_base)
        k = rope_rotate(k, pos, rope_base)
    # GQA: k/v stay narrow; the kernels map query heads to kv heads and
    # the ring rotates the narrow blocks
    if seq_layout == "zigzag":
        o = zigzag_ring_attention(q, k, v, sp_axis, causal=True)
    elif seq_layout == "contiguous":
        o = ring_attention(q, k, v, sp_axis, causal=True)
    else:
        raise ValueError(f"unknown seq_layout {seq_layout!r} — expected "
                         "'contiguous' or 'zigzag'")
    o = o.reshape(B, S, h_loc * head_dim)
    out = row_parallel_matmul(o, p["wo"].to(x.dtype), tp_axis,
                              _bias(p, "bo", x, use_bias))
    return with_lora(out, o, p, "wo", tp_axis=tp_axis)


def _mlp(x, p, tp_axis=None, use_bias: bool = True, seg=None):
    """The MLP branch: w1 (and the SwiGLU gate w3) column-parallel from
    the tp copy of ``x``, w2 row-parallel summed over tp before its
    bias; LoRA addends at the reference's points (value and gate paths,
    row projection), ``seg`` as in :func:`with_lora`."""
    x = copy_to_tp(x, tp_axis)
    h = col_parallel_matmul(x, p["w1"].to(x.dtype),
                            _bias(p, "b1", x, use_bias))
    h = with_lora(h, x, p, "w1", seg)
    if "w3" in p:
        g = col_parallel_matmul(x, p["w3"].to(x.dtype),
                                _bias(p, "b3", x, use_bias))
        g = with_lora(g, x, p, "w3", seg)
        h = F.silu(h) * g
    else:
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    out = row_parallel_matmul(h, p["w2"].to(x.dtype), tp_axis,
                              _bias(p, "b2", x, use_bias))
    return with_lora(out, h, p, "w2", seg, tp_axis)


def transformer_block(x, p, head_dim: int, tp_axis=None, sp_axis=None,
                      seq_layout: str = "contiguous", rope_base: float = 0.0,
                      norm_fn=_layernorm, norm_eps: float = 1e-5,
                      use_bias: bool = True,
                      pos: Optional[torch.Tensor] = None):
    """Pre-norm causal block: attention + MLP, each a residual branch,
    tp col/row-parallel, the sp ring, RoPE at the global positions
    ``pos``."""
    x = x + _attention(norm_fn(x, p["ln1_g"], p.get("ln1_b"), norm_eps), p,
                       head_dim, tp_axis, sp_axis, seq_layout=seq_layout,
                       rope_base=rope_base, use_bias=use_bias, pos=pos)
    return x + _mlp(norm_fn(x, p["ln2_g"], p.get("ln2_b"), norm_eps), p,
                    tp_axis, use_bias=use_bias)


def _embed(params, tokens: torch.Tensor, cfg: GPTConfig,
           pos0: int = 0, pos: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """Token (+ learned position) embeddings in the activation dtype for
    tokens at global positions ``pos`` (default ``pos0 ..``: the sp
    offset or the zigzag positions come in ``pos``)."""
    x = params["wte"][tokens]
    if cfg.pos_embedding == "learned":
        if pos is None:
            pos = torch.arange(pos0, pos0 + tokens.shape[1], device=x.device)
        x = x + params["wpe"][pos]
    return x.to(cfg.dtype)


class HeadDot(torch.autograd.Function):
    """Readout matmul with f32 logits, the reference's custom-VJP
    ``head_dot``: ``head`` rounds to the activation dtype (as every block
    matmul's weight does) and the product accumulates and returns in f32
    (the reference's ``preferred_element_type=f32`` dot, where a bf16
    ``matmul`` would round its output to bf16). Backward: the cotangent
    rounds to the activation dtype, ``dh`` comes out in it and the head
    gradient in f32, so the update of the f32 master weight loses
    nothing."""

    @staticmethod
    def forward(ctx, h, head):
        ctx.save_for_backward(h, head)
        return f32_dot(h, head.to(h.dtype))

    @staticmethod
    def backward(ctx, g):
        h, head = ctx.saved_tensors
        gc = g.to(h.dtype)
        dh = f32_dot(gc, head.to(h.dtype).T).to(h.dtype)
        d, V = head.shape
        dhead = f32_dot(h.reshape(-1, d).T, gc.reshape(-1, V))
        return dh, dhead.to(head.dtype)


def head_dot(h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """``h (..., d) @ head (d, V)`` → f32 logits (:class:`HeadDot`)."""
    return HeadDot.apply(h, head)


def _readout(params, h: torch.Tensor, norm_fn=_layernorm,
             norm_eps: float = 1e-5) -> torch.Tensor:
    """Final norm → f32 logits (tied ``wte.T`` unless ``lm_head``)."""
    h = norm_fn(h, params["lnf_g"], params.get("lnf_b"), norm_eps)
    head = params["lm_head"] if "lm_head" in params else params["wte"].T
    return head_dot(h, head)


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None].long())[..., 0]


def _readout_nll(params, h: torch.Tensor, targets: torch.Tensor,
                 norm_fn=_layernorm, norm_eps: float = 1e-5,
                 tp_axis=None, chunked=True) -> torch.Tensor:
    """Final norm → per-token next-token NLL. ``chunked`` is the
    tri-state ``chunked_ce`` knob: truthy takes the fused readout + CE
    (``ops/chunked_ce.py``), ``"vocab_parallel"`` with its vocab split
    over ``tp_axis``; False the dense ``head_dot`` + ``log_softmax``
    chain it is held against."""
    h = norm_fn(h, params["lnf_g"], params.get("lnf_b"), norm_eps)
    head = (params["lm_head"] if "lm_head" in params
            else params["wte"].T).float()
    if chunked:
        return chunked_ce_nll(
            h, head, targets,
            tp_axis=tp_axis if chunked == "vocab_parallel" else None)
    return _nll(head_dot(h, head), targets)


def gpt_hidden(params, tokens: torch.Tensor, cfg: GPTConfig,
               tp_axis=None, sp_axis=None, remat: bool = False,
               seq_layout: str = "contiguous") -> torch.Tensor:
    """Embeddings → transformer blocks, before the final norm.
    ``tokens`` is this rank's (B, S_local) block; ``remat=True``
    recomputes each block's activations in the backward pass
    (``parallel/remat.py``)."""
    rope_base = resolve_rope(cfg)
    norm_fn, norm_eps = resolve_norm(cfg)
    pos = _positions(tokens.shape[1], sp_axis, seq_layout, tokens.device)
    x = _embed(params, tokens, cfg, pos=pos)

    def apply_block(x, p):
        return transformer_block(x, p, cfg.head_dim, tp_axis, sp_axis,
                                 seq_layout=seq_layout, rope_base=rope_base,
                                 norm_fn=norm_fn, norm_eps=norm_eps,
                                 use_bias=cfg.use_bias, pos=pos)

    apply_block = maybe_remat(apply_block, remat)
    for p in params["blocks"]:
        x = apply_block(x, p)
    return x


@torch.no_grad()
def gpt_forward(params, tokens: torch.Tensor, cfg: GPTConfig,
                tp_axis=None, sp_axis=None,
                seq_layout: str = "contiguous") -> torch.Tensor:
    """tokens (B, S_local) → f32 logits (B, S_local, vocab), this rank's
    block (replicated over tp)."""
    x = gpt_hidden(params, tokens, cfg, tp_axis, sp_axis,
                   seq_layout=seq_layout)
    return _readout(params, x, *resolve_norm(cfg))


def gpt_pp_loss(params, tokens: torch.Tensor, targets: torch.Tensor,
                cfg: GPTConfig, pp_axis, n_micro: int, tp_axis=None,
                sp_axis=None, remat: bool = False,
                seq_layout: str = "contiguous",
                chunked_ce=True) -> torch.Tensor:
    """Pipeline-parallel next-token loss. ``params["blocks"]`` is this
    stage's stacked slab (``params.stacked``); the embeddings and the
    final norm are on every stage. The rank's batch splits into
    ``n_micro`` microbatches that run through the stages
    (:func:`~byteps_tpu_torch.parallel.pipeline.pipeline_apply`), and
    the last stage reads out the loss, its mean over ``sp_axis``.
    Returns the masked per-stage loss: that value on the last stage,
    0.0 elsewhere, which still reaches the pipeline's graph, so the
    backward of every stage runs its half of the backward pipeline.
    Differentiate this value; replicate it over pp afterwards for
    reporting."""
    from byteps_tpu_torch.parallel.pipeline import (is_last_stage,
                                                    pipeline_apply)

    B, S_loc = tokens.shape
    if B % n_micro != 0:
        raise ValueError(f"local batch {B} not divisible by {n_micro} "
                         "microbatches")
    rope_base = resolve_rope(cfg)
    norm_fn, norm_eps = resolve_norm(cfg)
    pos = _positions(S_loc, sp_axis, seq_layout, tokens.device)
    x = _embed(params, tokens, cfg, pos=pos)
    x_mb = x.reshape(n_micro, B // n_micro, S_loc, x.shape[-1])

    def blk(h, p):
        return transformer_block(h, p, cfg.head_dim, tp_axis, sp_axis,
                                 seq_layout=seq_layout, rope_base=rope_base,
                                 norm_fn=norm_fn, norm_eps=norm_eps,
                                 use_bias=cfg.use_bias, pos=pos)

    y_mb = pipeline_apply(x_mb, params["blocks"], blk, pp_axis, remat=remat)
    if not is_last_stage(pp_axis):
        # zeros: the value 0.0 and the way into the pipeline's backward
        return y_mb.float().sum()
    y = y_mb.reshape(B, S_loc, -1)
    loss = _readout_nll(params, y, targets, norm_fn, norm_eps,
                        tp_axis=tp_axis, chunked=chunked_ce).mean()
    return pmean(loss, sp_axis)


def gpt_loss(params, tokens: torch.Tensor, targets: torch.Tensor,
             cfg: GPTConfig, dp_axis=None, tp_axis=None, sp_axis=None,
             remat: bool = False, seq_layout: str = "contiguous",
             chunked_ce=True) -> torch.Tensor:
    """Mean next-token cross-entropy, f32, differentiable, the same on
    every rank of the named axes: the mean of this rank's block, then the
    mean over ``dp_axis`` and ``sp_axis`` (:func:`~byteps_tpu_torch
    .parallel.tp.pmean`, whose backward hands each rank its own share),
    replicated over tp by construction. ``chunked_ce``: True (default)
    fuses readout + CE so the f32 (B, S, V) logits never exist whole,
    ``"vocab_parallel"`` also splits the readout's vocab over tp, False
    is the dense chain."""
    x = gpt_hidden(params, tokens, cfg, tp_axis, sp_axis, remat=remat,
                   seq_layout=seq_layout)
    loss = _readout_nll(params, x, targets, *resolve_norm(cfg),
                        tp_axis=tp_axis, chunked=chunked_ce).mean()
    for axis in (dp_axis, sp_axis):
        loss = pmean(loss, axis)
    return loss
