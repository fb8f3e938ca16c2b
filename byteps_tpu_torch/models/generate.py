"""Autoregressive generation with a KV cache for the GPT family.

Counterpart of ``byteps_tpu/models/generate.py``: a static-shape cache
``(n_layers, B, max_seq, h_kv, head_dim)``, one cached-attention code
path for prefill and decode, greedy or sampled picks. Where the
reference threads the cache functionally (``dynamic_update_slice``
inside a ``lax.scan``), the port writes it in place and loops in
Python; ``KVCache.length`` is a host integer.

Dispatch follows the reference: a prefill (T > 1) goes through
``attention_lse`` with a scalar offset (the forward kernel on CUDA), a
single-token step through ``flash_decode`` (the decode kernel on CUDA).

Sharded decode takes the port's mesh :class:`~byteps_tpu_torch.parallel
.mesh.Axis` objects where the reference takes axis names, as the train
factories do: under ``tp_axis`` each rank holds its Megatron shard (its
heads of q/k/v, its rows of ``wo`` and ``w2``, its ff columns), the cache
holds its kv heads (sized from the local ``wk`` shard), and the
row-parallel products (``wo``, the MLP's ``w2``, a grafted ``wo``/``w2``
delta's thin intermediate) are summed over tp; under ``ep_axis`` an MoE
block's experts are this rank's, and its tokens reach them through the
no-drop exchange over ep (``parallel/moe.moe_ffn(no_drop=True)``). Every
rank of the job runs the whole batch, so every rank computes the same
logits and picks the same tokens.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from byteps_tpu_torch.models.gpt import (
    GPTConfig,
    _bias,
    _embed,
    _layernorm,
    _mlp,
    _readout,
    resolve_norm,
    resolve_rope,
    rope_rotate,
    with_lora,
)
from byteps_tpu_torch.ops.backend import resolve_device
from byteps_tpu_torch.ops.flash_attention import attention_lse, supported
from byteps_tpu_torch.ops.flash_decode import flash_decode
from byteps_tpu_torch.parallel.moe import moe_ffn
from byteps_tpu_torch.parallel.tp import (
    col_parallel_matmul,
    row_parallel_matmul,
)


class KVCache(NamedTuple):
    """Static-shape per-layer key/value cache.

    k/v: (n_layers, B, max_seq, h_kv, head_dim); ``length`` is the fill
    level (tokens already written). With ``init_cache(..., quant=True)``
    k/v are int8 and ``k_scale``/``v_scale`` (n_layers, B, max_seq, h_kv)
    hold f32 per-(position, head) scales. Updated in place.
    """
    k: torch.Tensor
    v: torch.Tensor
    length: int
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


def init_cache(cfg: GPTConfig, batch: int, h_loc: Optional[int] = None,
               quant: bool = False, device=None) -> KVCache:
    """An empty cache of ``cfg.max_seq`` positions on ``device`` (the
    card unless told otherwise); ``h_loc`` kv heads (default
    ``cfg.kv_heads``)."""
    dev = resolve_device(device)
    h = h_loc if h_loc is not None else cfg.kv_heads
    shape = (cfg.n_layers, batch, cfg.max_seq, h, cfg.head_dim)
    if quant:
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            length=0,
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
        )
    return KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   length=0)


class _QuantSlot(NamedTuple):
    """One layer's quantized cache side: int8 values + f32 scales."""
    q: torch.Tensor
    scale: torch.Tensor


def _quantize_block(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, h, D) → (int8 values, f32 per-(B, T, h) scales): symmetric
    absmax over head_dim; a zero row gets scale 1e-12."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-12)
    q = torch.round(xf / scale[..., None])
    return q.to(torch.int8), scale


def _cache_write(cache, new: torch.Tensor, pos0: int):
    """Write ``new`` (B, T, h, D) at positions pos0.. of ``cache`` — a
    dense (B, S, h, D) tensor or a :class:`_QuantSlot` — in place."""
    T = new.shape[1]
    if isinstance(cache, _QuantSlot):
        q, s = _quantize_block(new)
        cache.q[:, pos0:pos0 + T] = q
        cache.scale[:, pos0:pos0 + T] = s
        return cache
    cache[:, pos0:pos0 + T] = new.to(cache.dtype)
    return cache


def _cache_read(cache, dtype: torch.dtype) -> torch.Tensor:
    """The attention-ready (B, S, h, D) view in ``dtype``; int8 entries
    dequantize through their scales."""
    if isinstance(cache, _QuantSlot):
        return (cache.q.float() * cache.scale[..., None]).to(dtype)
    return cache


def _cached_attention(q, k_cache, v_cache, q_pos0: int):
    """q (B, T, H, D) at positions q_pos0.. against the cache with the
    new keys written; positions past the fill level are masked."""
    o, _ = attention_lse(q, k_cache, v_cache, q_pos0, 0, causal=True)
    return o


def _attn_cached_half(x, p, cache_k, cache_v, pos0: int, head_dim: int,
                      tp_axis=None, rope_base: float = 0.0,
                      norm_fn=_layernorm, norm_eps: float = 1e-5,
                      use_bias: bool = True):
    """The attention residual branch over T new tokens with cache
    append; returns (x_out, cache_k, cache_v). Keys are cached after
    rotation. Under ``tp_axis`` the heads and the cache are this rank's
    and the output projection is summed over tp."""
    B, T = x.shape[:2]
    h = norm_fn(x, p["ln1_g"], p.get("ln1_b"), norm_eps)
    q = col_parallel_matmul(h, p["wq"].to(x.dtype), _bias(p, "bq", x, use_bias))
    k = col_parallel_matmul(h, p["wk"].to(x.dtype), _bias(p, "bk", x, use_bias))
    v = col_parallel_matmul(h, p["wv"].to(x.dtype), _bias(p, "bv", x, use_bias))
    # a grafted tree decodes as gpt_forward computes it: base + delta
    q = with_lora(q, h, p, "wq")
    k = with_lora(k, h, p, "wk")
    v = with_lora(v, h, p, "wv")
    h_loc = q.shape[-1] // head_dim
    kv_loc = k.shape[-1] // head_dim    # GQA: the cache holds kv heads only
    q = q.reshape(B, T, h_loc, head_dim)
    k = k.reshape(B, T, kv_loc, head_dim)
    v = v.reshape(B, T, kv_loc, head_dim)
    if rope_base > 0.0:
        pos = torch.arange(pos0, pos0 + T, device=x.device)
        q = rope_rotate(q, pos, rope_base)
        k = rope_rotate(k, pos, rope_base)
    cache_k = _cache_write(cache_k, k, pos0)
    cache_v = _cache_write(cache_v, v, pos0)
    quant = isinstance(cache_k, _QuantSlot)
    if T == 1 and supported(head_dim):
        if quant:
            o = flash_decode(q, cache_k.q, cache_v.q, pos0,
                             k_scale=cache_k.scale, v_scale=cache_v.scale)
        else:
            o = flash_decode(q, cache_k, cache_v, pos0)
    else:
        o = _cached_attention(q, _cache_read(cache_k, x.dtype),
                              _cache_read(cache_v, x.dtype), pos0)
    o = o.reshape(B, T, h_loc * head_dim)
    attn_out = row_parallel_matmul(o, p["wo"].to(x.dtype), tp_axis,
                                   _bias(p, "bo", x, use_bias))
    attn_out = with_lora(attn_out, o, p, "wo", tp_axis=tp_axis)
    return x + attn_out, cache_k, cache_v


def _block_step(x, p, cache_k, cache_v, pos0: int, cfg: GPTConfig,
                tp_axis=None, ep_axis=None, norm_fn=_layernorm,
                norm_eps: float = 1e-5):
    """One transformer block (dense MLP, or MoE by its parameters) over T
    new tokens with cache append. An MoE block routes with no-drop
    capacity, as the reference's decode does: a token dropped at decode
    time would corrupt the sample."""
    x, cache_k, cache_v = _attn_cached_half(
        x, p, cache_k, cache_v, pos0, cfg.head_dim, tp_axis,
        rope_base=(cfg.rope_base if cfg.pos_embedding == "rope" else 0.0),
        norm_fn=norm_fn, norm_eps=norm_eps, use_bias=cfg.use_bias)
    h = norm_fn(x, p["ln2_g"], p.get("ln2_b"), norm_eps)
    if "moe" in p:
        m, _aux = moe_ffn(h, p["moe"], ep_axis=ep_axis,
                          router_topk=cfg.router_topk, tp_axis=tp_axis,
                          no_drop=True)
        return x + m, cache_k, cache_v
    return x + _mlp(h, p, tp_axis, use_bias=cfg.use_bias), cache_k, cache_v


@torch.no_grad()
def gpt_apply_cached(params, tokens: torch.Tensor, cache: KVCache,
                     cfg: GPTConfig, tp_axis=None, ep_axis=None,
                     readout: bool = True
                     ) -> Tuple[Optional[torch.Tensor], KVCache]:
    """Run T new tokens (B, T), continuing at ``cache.length``, through
    the model, writing their keys/values into ``cache`` in place.
    Returns (f32 logits (B, T, vocab) or None when ``readout=False``,
    the cache at its new length). Dense and MoE GPT families (the block
    type from its parameters); ``tp_axis``/``ep_axis`` as in the module
    docstring."""
    resolve_rope(cfg)
    norm_fn, norm_eps = resolve_norm(cfg)
    T = tokens.shape[1]
    pos0 = cache.length
    x = _embed(params, tokens, cfg, pos0)
    quant = cache.k_scale is not None
    for li, p in enumerate(params["blocks"]):
        ck = _QuantSlot(cache.k[li], cache.k_scale[li]) if quant else cache.k[li]
        cv = _QuantSlot(cache.v[li], cache.v_scale[li]) if quant else cache.v[li]
        x, _, _ = _block_step(x, p, ck, cv, pos0, cfg, tp_axis, ep_axis,
                              norm_fn=norm_fn, norm_eps=norm_eps)
    logits = _readout(params, x, norm_fn, norm_eps) if readout else None
    return logits, cache._replace(length=pos0 + T)


def make_truncate(top_k: Optional[int], top_p: Optional[float],
                  vocab_size: int):
    """The per-step logits filter: mask logits outside the top-k set
    and/or the top-p nucleus (both on the raw distribution; ties at the
    threshold are all kept)."""
    if top_k is not None and not 1 <= top_k <= vocab_size:
        raise ValueError(f"top_k must be in [1, vocab]; got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1]; got {top_p}")
    neg_inf = float("-inf")

    def _truncate(logits_t: torch.Tensor) -> torch.Tensor:
        if top_k is None and top_p is None:
            return logits_t
        if top_p is None:
            vals = torch.topk(logits_t, top_k, dim=-1).values
            return torch.where(logits_t >= vals[:, -1:], logits_t, neg_inf)
        thresh = torch.full_like(logits_t[:, :1], neg_inf)
        sorted_desc = torch.sort(logits_t, dim=-1, descending=True).values
        if top_k is not None:
            thresh = torch.maximum(thresh, sorted_desc[:, top_k - 1:top_k])
        cum = torch.cumsum(F.softmax(sorted_desc, dim=-1), dim=-1)
        # keep every token whose PRECEDING cumulative mass < top_p
        keep = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]],
                         dim=-1) < top_p
        thresh = torch.maximum(thresh, torch.where(
            keep, sorted_desc, float("inf")).amin(dim=-1, keepdim=True))
        return torch.where(logits_t >= thresh, logits_t, neg_inf)

    return _truncate


def make_pick(truncate):
    """Per-step token selection: exact argmax (first maximum) at
    ``temperature == 0``, else a draw from the truncated distribution at
    ``temperature`` by the Gumbel-max rule with ``generator``'s bits."""

    def pick(logits_t: torch.Tensor, generator: Optional[torch.Generator],
             temperature: float) -> torch.Tensor:
        if temperature <= 0.0:
            return torch.argmax(logits_t, dim=-1).to(torch.int32)
        z = truncate(logits_t) / max(temperature, 1e-6)
        u = torch.rand(z.shape, generator=generator, device=z.device)
        return torch.argmax(z - torch.log(-torch.log(u)),
                            dim=-1).to(torch.int32)

    return pick


def make_generate_fn(cfg: GPTConfig, max_new: int, tp_axis=None,
                     ep_axis=None, top_k: Optional[int] = None,
                     top_p: Optional[float] = None,
                     quant_cache: bool = False, device=None):
    """Build ``gen(params, prompt, generator=None, temperature=0.0)``:
    prompt (B, T0) int32 → (B, T0 + max_new) int32 tokens on ``device``
    (the card unless told otherwise). Greedy at ``temperature == 0``,
    else sampled (optionally top-k / top-p truncated) with
    ``generator``'s bits. One cached prefill, then one single-token step
    per generated token. ``quant_cache=True`` stores k/v as int8 with
    per-(position, head) scales.

    ``tp_axis``/``ep_axis`` (mesh ``Axis`` objects) shard the model as
    the module docstring says; ``params`` are then this rank's shards
    (``convert.params_from_numpy(..., mesh=)``) and the whole prompt is
    every rank's. Sampling under a live axis needs one thing of the
    caller: every rank draws the same bits, so each passes a generator
    of the same seed (the default, seed 0, is the same on every rank);
    the ranks then hold the same logits and pick the same tokens, and
    the collectives of the next step stay in step."""
    dev = resolve_device(device)
    _pick = make_pick(make_truncate(top_k, top_p, cfg.vocab_size))

    @torch.no_grad()
    def gen(params, prompt, generator: Optional[torch.Generator] = None,
            temperature: float = 0.0) -> torch.Tensor:
        if isinstance(prompt, torch.Tensor):
            prompt = prompt.to(device=dev, dtype=torch.int32)
        else:
            prompt = torch.as_tensor(np.asarray(prompt, np.int32), device=dev)
        B, T0 = prompt.shape
        if T0 + max_new > cfg.max_seq:
            raise ValueError(
                f"prompt ({T0}) + max_new ({max_new}) exceeds "
                f"cfg.max_seq ({cfg.max_seq})")
        if temperature > 0.0 and generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        kv_loc = params["blocks"][0]["wk"].shape[-1] // cfg.head_dim
        cache = init_cache(cfg, B, h_loc=kv_loc, quant=quant_cache,
                           device=dev)
        logits, cache = gpt_apply_cached(params, prompt, cache, cfg,
                                         tp_axis, ep_axis)
        toks = []
        for i in range(max_new):
            tok = _pick(logits[:, -1], generator, temperature)    # (B,)
            toks.append(tok)
            if i + 1 < max_new:
                logits, cache = gpt_apply_cached(params, tok[:, None],
                                                 cache, cfg, tp_axis,
                                                 ep_axis)
        return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)

    return gen
