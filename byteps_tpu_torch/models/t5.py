"""T5-style encoder–decoder: the teacher-forced seq2seq loss and cached
generation.

Counterpart of ``byteps_tpu/models/t5.py``. Built from the GPT family's
parts (``models/gpt.py``): the encoder blocks are ``transformer_block``
with ``causal=False``; a decoder block is causal self-attention, a
pre-LN cross-attention sublayer (decoder queries over the encoder
memory, column-parallel q/k/v and a row-parallel output over tp), then
the MLP; embeddings and readout are tied (``wte``) with learned absolute
positions a side. Leaf names and layouts are the reference's, held in a
:class:`~byteps_tpu_torch.models.gpt.ParamTree`.

Under an sp axis both sides shard their sequence: the encoder runs the
non-causal ring, the decoder the causal ring, and cross-attention a
rectangular non-causal ring (each rank's target queries stay, the
encoder-memory k/v blocks rotate; ``parallel/ring_attention.py`` offsets
a k block by its own length).

Generation (:func:`make_t5_generate_fn`) encodes the source once,
projects each decoder layer's cross-attention k/v once
(:func:`t5_cross_kv`), then runs one cached decoder step a token from
BOS (id 0): the self-attention through ``models/generate.py``'s
``_attn_cached_half`` (a one-token step is the decode kernel on the
card), the cross-attention through ``plain_attention(causal=False)``
(the forward kernel). Where the reference scans, the port loops in
Python and writes the cache in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from byteps_tpu_torch.models.gpt import (
    ParamTree,
    _attention,
    _layernorm,
    _mlp,
    _positions,
    _readout,
    _readout_nll,
    block_init,
    block_logical_specs,
    transformer_block,
)
from byteps_tpu_torch.ops.backend import resolve_device
from byteps_tpu_torch.parallel.remat import maybe_remat
from byteps_tpu_torch.parallel.ring_attention import (
    plain_attention,
    ring_attention,
)
from byteps_tpu_torch.parallel.tp import (
    col_parallel_matmul,
    copy_to_tp,
    pmean,
    row_parallel_matmul,
)


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    max_src: int = 512
    max_tgt: int = 512
    d_model: int = 768
    n_heads: int = 12
    n_enc_layers: int = 12
    n_dec_layers: int = 12
    d_ff: int = 3072
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def tiny(cls) -> "T5Config":
        return cls(vocab_size=256, max_src=64, max_tgt=64, d_model=64,
                   n_heads=4, n_enc_layers=2, n_dec_layers=2, d_ff=128)

    @classmethod
    def base(cls) -> "T5Config":
        return cls(dtype=torch.bfloat16)


def _cross_init(generator: torch.Generator, d: int, hd: int, n_layers: int,
                dev: torch.device) -> Dict[str, torch.Tensor]:
    """The cross-attention sublayer's leaves (decoder q over encoder
    k/v): N(0, 0.02²) weights, ``xwo`` scaled by 1/sqrt(2·n_layers)."""
    def dense(*shape):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * 0.02

    def const(n, v):
        return torch.full((n,), v, dtype=torch.float32, device=dev)

    return {
        "lnx_g": const(d, 1.0), "lnx_b": const(d, 0.0),
        "xwq": dense(d, hd), "xbq": const(hd, 0.0),
        "xwk": dense(d, hd), "xbk": const(hd, 0.0),
        "xwv": dense(d, hd), "xbv": const(hd, 0.0),
        "xwo": dense(hd, d) / (2 * n_layers) ** 0.5,
        "xbo": const(d, 0.0),
    }


def _cross_logical_specs() -> Dict[str, Any]:
    return {
        "lnx_g": ("embed",), "lnx_b": ("embed",),
        "xwq": ("embed", "heads"), "xbq": ("heads",),
        "xwk": ("embed", "kv"), "xbk": ("kv",),
        "xwv": ("embed", "kv"), "xbv": ("kv",),
        "xwo": ("heads", "embed"), "xbo": ("embed",),
    }


def cross_attention(x, mem, p, head_dim: int, tp_axis=None, sp_axis=None):
    """Decoder queries ``x`` over encoder memory ``mem``, bidirectional.
    Under ``sp_axis`` both are this rank's sequence blocks and the memory
    k/v blocks rotate round the ring under the queries (rectangular,
    non-causal); under ``tp_axis`` the heads are this rank's."""
    B, Sq = x.shape[:2]
    Sk = mem.shape[1]
    x = copy_to_tp(x, tp_axis)
    mem = copy_to_tp(mem, tp_axis)
    q = col_parallel_matmul(x, p["xwq"].to(x.dtype), p["xbq"].to(x.dtype))
    k = col_parallel_matmul(mem, p["xwk"].to(mem.dtype),
                            p["xbk"].to(mem.dtype))
    v = col_parallel_matmul(mem, p["xwv"].to(mem.dtype),
                            p["xbv"].to(mem.dtype))
    h_loc = q.shape[-1] // head_dim
    q = q.reshape(B, Sq, h_loc, head_dim)
    k = k.reshape(B, Sk, h_loc, head_dim)
    v = v.reshape(B, Sk, h_loc, head_dim)
    o = ring_attention(q, k, v, sp_axis, causal=False)
    o = o.reshape(B, Sq, h_loc * head_dim)
    return row_parallel_matmul(o, p["xwo"].to(x.dtype), tp_axis,
                               p["xbo"].to(x.dtype))


def decoder_block(x, mem, p, head_dim: int, tp_axis=None, sp_axis=None):
    """Causal self-attention → cross-attention over ``mem`` → MLP, each
    pre-LN: a GPT block's leaves plus :func:`_cross_init`'s."""
    x = x + _attention(_layernorm(x, p["ln1_g"], p["ln1_b"]), p, head_dim,
                       tp_axis, sp_axis, causal=True)
    x = x + cross_attention(_layernorm(x, p["lnx_g"], p["lnx_b"]), mem, p,
                            head_dim, tp_axis, sp_axis)
    return x + _mlp(_layernorm(x, p["ln2_g"], p["ln2_b"]), p, tp_axis)


def t5_init(cfg: T5Config, generator: Optional[torch.Generator] = None,
            device=None) -> ParamTree:
    """Random parameters for ``cfg`` on ``device`` (the card unless told
    otherwise) from ``generator`` (default: seed 0 on that device)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d = cfg.d_model
    hd = cfg.n_heads * cfg.head_dim
    n_total = cfg.n_enc_layers + cfg.n_dec_layers

    def dense(*shape):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=torch.float32) * 0.02

    def const(n, v):
        return torch.full((n,), v, dtype=torch.float32, device=dev)

    enc = [block_init(generator, d, cfg.d_ff, hd, n_total, device=dev)
           for _ in range(cfg.n_enc_layers)]
    dec = []
    for _ in range(cfg.n_dec_layers):
        p = block_init(generator, d, cfg.d_ff, hd, n_total, device=dev)
        p.update(_cross_init(generator, d, hd, n_total, dev))
        dec.append(p)
    tree = {
        "wte": dense(cfg.vocab_size, d),
        "wpe_src": dense(cfg.max_src, d),
        "wpe_tgt": dense(cfg.max_tgt, d),
        "enc_blocks": enc, "dec_blocks": dec,
        "enc_ln_g": const(d, 1.0), "enc_ln_b": const(d, 0.0),
        "lnf_g": const(d, 1.0), "lnf_b": const(d, 0.0),
    }
    return ParamTree(cfg, tree)


def t5_logical_specs(cfg: T5Config) -> Dict[str, Any]:
    dec = []
    for _ in range(cfg.n_dec_layers):
        s = block_logical_specs()
        s.update(_cross_logical_specs())
        dec.append(s)
    return {
        "wte": ("vocab", "embed"), "wpe_src": (None, "embed"),
        "wpe_tgt": (None, "embed"),
        "enc_blocks": [block_logical_specs()
                       for _ in range(cfg.n_enc_layers)],
        "dec_blocks": dec,
        "enc_ln_g": ("embed",), "enc_ln_b": ("embed",),
        "lnf_g": ("embed",), "lnf_b": ("embed",),
    }


def t5_param_specs(cfg: T5Config, tp_axis: Optional[str]) -> Dict[str, Any]:
    from byteps_tpu_torch.parallel.partitioner import (resolve_specs,
                                                       rules_from_axes)
    return resolve_specs(t5_logical_specs(cfg),
                         rules_from_axes(tp_axis=tp_axis))


def t5_encode(params, src: torch.Tensor, cfg: T5Config, tp_axis=None,
              sp_axis=None, remat: bool = False) -> torch.Tensor:
    """(B, S_src) token ids (this rank's contiguous block under sp) →
    (B, S_src, d) encoder memory."""
    pos = _positions(src.shape[1], sp_axis, "contiguous", src.device)
    x = (params["wte"][src] + params["wpe_src"][pos]).to(cfg.dtype)

    def apply_block(x, p):
        return transformer_block(x, p, cfg.head_dim, tp_axis, sp_axis,
                                 causal=False)

    apply_block = maybe_remat(apply_block, remat)
    for p in params["enc_blocks"]:
        x = apply_block(x, p)
    return _layernorm(x, params["enc_ln_g"], params["enc_ln_b"])


def t5_decode(params, mem: torch.Tensor, tgt_in: torch.Tensor,
              cfg: T5Config, tp_axis=None, sp_axis=None,
              remat: bool = False, readout: bool = True) -> torch.Tensor:
    """Teacher-forced decode: (B, S_tgt) shifted ids → f32 logits; with
    ``readout=False`` the decoder's hidden states before the final norm
    (what :func:`t5_loss`'s fused readout + CE takes)."""
    pos = _positions(tgt_in.shape[1], sp_axis, "contiguous", tgt_in.device)
    x = (params["wte"][tgt_in] + params["wpe_tgt"][pos]).to(cfg.dtype)

    def apply_block(x, p):
        return decoder_block(x, mem, p, cfg.head_dim, tp_axis, sp_axis)

    apply_block = maybe_remat(apply_block, remat)
    for p in params["dec_blocks"]:
        x = apply_block(x, p)
    return _readout(params, x) if readout else x


def t5_forward(params, src: torch.Tensor, tgt_in: torch.Tensor,
               cfg: T5Config, tp_axis=None, sp_axis=None,
               remat: bool = False) -> torch.Tensor:
    mem = t5_encode(params, src, cfg, tp_axis=tp_axis, sp_axis=sp_axis,
                    remat=remat)
    return t5_decode(params, mem, tgt_in, cfg, tp_axis=tp_axis,
                     sp_axis=sp_axis, remat=remat)


def t5_loss(params, src: torch.Tensor, tgt_in: torch.Tensor,
            tgt_out: torch.Tensor, cfg: T5Config, dp_axis=None,
            tp_axis=None, sp_axis=None, remat: bool = False,
            chunked_ce=True) -> torch.Tensor:
    """Mean next-token CE over the target side (teacher forcing), the
    mean of this rank's block, then over ``dp_axis`` and ``sp_axis``
    (equal blocks, so the mean of means is exact), replicated over tp.
    ``chunked_ce`` as in ``gpt_loss``."""
    mem = t5_encode(params, src, cfg, tp_axis=tp_axis, sp_axis=sp_axis,
                    remat=remat)
    x = t5_decode(params, mem, tgt_in, cfg, tp_axis=tp_axis,
                  sp_axis=sp_axis, remat=remat, readout=False)
    loss = _readout_nll(params, x, tgt_out, tp_axis=tp_axis,
                        chunked=chunked_ce).mean()
    for axis in (dp_axis, sp_axis):
        loss = pmean(loss, axis)
    return loss


def synthetic_seq2seq_batch(generator: torch.Generator, cfg: T5Config,
                            batch: int, src_len: int, tgt_len: int):
    """``(src, tgt_in, tgt_out)``: random ids drawn from ``generator`` on
    its device, the target shifted right behind BOS = 0."""
    dev = generator.device
    src = torch.randint(0, cfg.vocab_size, (batch, src_len),
                        generator=generator, device=dev)
    tgt = torch.randint(0, cfg.vocab_size, (batch, tgt_len + 1),
                        generator=generator, device=dev)
    tgt[:, 0] = 0
    return src, tgt[:, :-1], tgt[:, 1:]


# ---- cached seq2seq generation ---------------------------------------------
class T5DecCache(NamedTuple):
    """The decoder's self-attention cache, (n_dec, B, max_tgt, H, D) k and
    v written in place, and its fill level (a host integer). The
    cross-attention k/v are not cached here: :func:`t5_cross_kv` projects
    them once from the encoder memory."""
    k: torch.Tensor
    v: torch.Tensor
    length: int


def t5_init_cache(cfg: T5Config, batch: int, h_loc: Optional[int] = None,
                  device=None) -> T5DecCache:
    """An empty cache on ``device`` (the card unless told otherwise);
    ``h_loc`` heads (default ``cfg.n_heads``)."""
    dev = resolve_device(device)
    h = h_loc if h_loc is not None else cfg.n_heads
    shape = (cfg.n_dec_layers, batch, cfg.max_tgt, h, cfg.head_dim)
    return T5DecCache(k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                      v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                      length=0)


@torch.no_grad()
def t5_cross_kv(params, mem: torch.Tensor, cfg: T5Config):
    """Each decoder layer's cross-attention k/v from the encoder memory:
    a stacked (n_dec, B, S_src, h_loc, D) pair."""
    ks, vs = [], []
    B, Sk = mem.shape[:2]
    for p in params["dec_blocks"]:
        k = col_parallel_matmul(mem, p["xwk"].to(mem.dtype),
                                p["xbk"].to(mem.dtype))
        v = col_parallel_matmul(mem, p["xwv"].to(mem.dtype),
                                p["xbv"].to(mem.dtype))
        h_loc = k.shape[-1] // cfg.head_dim
        ks.append(k.reshape(B, Sk, h_loc, cfg.head_dim))
        vs.append(v.reshape(B, Sk, h_loc, cfg.head_dim))
    return torch.stack(ks), torch.stack(vs)


@torch.no_grad()
def t5_decode_cached(params, tgt_tokens: torch.Tensor, cache: T5DecCache,
                     cross_k: torch.Tensor, cross_v: torch.Tensor,
                     cfg: T5Config, tp_axis=None):
    """Run T new target tokens (B, T), continuing at ``cache.length``,
    through the decoder, writing their self-attention k/v into the cache
    in place. T = 1 is one decode step; any T equals :func:`t5_decode`
    over the same tokens. Returns (f32 logits (B, T, V), the cache at
    its new length)."""
    from byteps_tpu_torch.models.generate import _attn_cached_half

    B, T = tgt_tokens.shape
    pos0 = cache.length
    pos = torch.arange(pos0, pos0 + T, device=tgt_tokens.device)
    x = (params["wte"][tgt_tokens] + params["wpe_tgt"][pos]).to(cfg.dtype)
    hd = cfg.head_dim
    for li, p in enumerate(params["dec_blocks"]):
        # causal self-attention over the cache: generate's one cached path
        x, _, _ = _attn_cached_half(x, p, cache.k[li], cache.v[li], pos0, hd,
                                    tp_axis)
        h_loc = cache.k.shape[-2]     # no GQA: query heads == kv heads
        # cross-attention over the precomputed encoder k/v
        h = _layernorm(x, p["lnx_g"], p["lnx_b"])
        q = col_parallel_matmul(h, p["xwq"].to(x.dtype),
                                p["xbq"].to(x.dtype)).reshape(B, T, h_loc, hd)
        o = plain_attention(q, cross_k[li].to(q.dtype),
                            cross_v[li].to(q.dtype), causal=False)
        x = x + row_parallel_matmul(o.reshape(B, T, h_loc * hd),
                                    p["xwo"].to(x.dtype), tp_axis,
                                    p["xbo"].to(x.dtype))
        x = x + _mlp(_layernorm(x, p["ln2_g"], p["ln2_b"]), p, tp_axis)
    return _readout(params, x), cache._replace(length=pos0 + T)


def make_t5_generate_fn(cfg: T5Config, max_new: int, tp_axis=None,
                        top_k: Optional[int] = None,
                        top_p: Optional[float] = None, device=None):
    """Build ``gen(params, src, generator=None, temperature=0.0)``: src
    (B, S_src) ids → (B, max_new) int32 generated ids on ``device`` (the
    card unless told otherwise). The source is encoded once and each
    decoder layer's cross k/v projected once; then ``max_new`` one-token
    cached steps from BOS (id 0). Greedy at ``temperature == 0``, else
    sampled (optionally top-k / top-p truncated, ``generate.py``'s
    ``make_truncate``) with ``generator``'s bits. Under ``tp_axis``
    ``params`` are this rank's shards and every rank picks the same
    tokens (as ``make_generate_fn``). Raises at once when BOS + max_new
    exceeds ``cfg.max_tgt`` (the cache and ``wpe_tgt`` end there)."""
    from byteps_tpu_torch.models.generate import make_pick, make_truncate

    if 1 + max_new > cfg.max_tgt:
        raise ValueError(f"BOS + max_new ({1 + max_new}) exceeds "
                         f"cfg.max_tgt ({cfg.max_tgt})")
    dev = resolve_device(device)
    _pick = make_pick(make_truncate(top_k, top_p, cfg.vocab_size))

    @torch.no_grad()
    def gen(params, src, generator: Optional[torch.Generator] = None,
            temperature: float = 0.0) -> torch.Tensor:
        if isinstance(src, torch.Tensor):
            src = src.to(device=dev, dtype=torch.long)
        else:
            src = torch.as_tensor(np.asarray(src, np.int64), device=dev)
        if temperature > 0.0 and generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        B = src.shape[0]
        mem = t5_encode(params, src, cfg, tp_axis=tp_axis)
        cross_k, cross_v = t5_cross_kv(params, mem, cfg)
        cache = t5_init_cache(cfg, B, h_loc=cross_k.shape[-2], device=dev)
        tok = torch.zeros((B, 1), dtype=torch.long, device=dev)
        toks = []
        for _ in range(max_new):
            logits, cache = t5_decode_cached(params, tok, cache, cross_k,
                                             cross_v, cfg, tp_axis=tp_axis)
            nxt = _pick(logits[:, -1], generator, temperature)
            toks.append(nxt)
            tok = nxt[:, None].long()
        return torch.stack(toks, dim=1)

    return gen
