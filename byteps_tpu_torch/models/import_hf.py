"""HuggingFace checkpoint bridge for the GPT family.

Counterpart of ``byteps_tpu/models/import_hf.py``: a GPT-2
(``GPT2LMHeadModel``) or Llama (``LlamaForCausalLM``) state dict goes
into the port's :class:`~byteps_tpu_torch.models.gpt.GPT` and back. The
source is a bare state dict (tensors or arrays) with its config (the HF
config object or a dict of its fields), or any object with a
``state_dict()`` method and a ``config`` attribute; this module never
imports ``transformers``.

Conventions bridged (both directions), as the reference's:

* GPT-2 stores its Conv1D weights ``(in, out)``, the port's layout, so
  nothing is transposed; the fused ``c_attn`` ``(d, 3d)`` splits into
  wq/wk/wv; the readout is tied.
* Llama stores ``nn.Linear`` weights ``(out, in)``: transposed on the way
  in and out. RMSNorm, rotary positions (the half-split convention both
  sides use), GQA (``num_key_value_heads``) and SwiGLU (``w1`` gate,
  ``w3`` up, ``w2`` down) map onto ``GPTConfig.llama``'s options; the
  tree carries no leaf the checkpoint lacks (no ``wpe``, no norm or
  projection biases unless the checkpoint has projection biases);
  ``lm_head`` is the untied readout unless ``tie_word_embeddings``.

The refusals are the reference's, with its messages: activations other
than GPT-2's tanh gelu, the GPT-2 attention variants it does not
implement, scaled rotary positions, and a head dim decoupled from
``hidden_size / num_attention_heads``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from byteps_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from byteps_tpu_torch.models.gpt import GPT, GPTConfig


def _np(t) -> np.ndarray:
    """A tensor or array-like as f32 numpy."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _state_and_config(source, config):
    """A model object (which carries its config) or a bare state dict
    (the config required)."""
    if hasattr(source, "state_dict"):
        cfg = config if config is not None else source.config
        return source.state_dict(), cfg
    if config is None:
        raise ValueError("a bare state_dict needs the HF config object "
                         "(or a dict of its fields) passed as config=")
    return dict(source), config


def _cfgget(hf_cfg, name, default=None):
    if isinstance(hf_cfg, dict):
        return hf_cfg.get(name, default)
    return getattr(hf_cfg, name, default)


def _tree(params) -> Dict[str, Any]:
    """A :class:`GPT` (or the reference's numpy tree) as a numpy tree."""
    return params_to_numpy(params) if isinstance(params, GPT) else params


def from_hf_gpt2(source, config=None, dtype: torch.dtype = torch.float32,
                 device=None) -> Tuple[GPTConfig, GPT]:
    """A GPT-2 state dict (or model) → ``(GPTConfig, GPT)`` on ``device``
    (the card unless told otherwise). ``dtype`` is the activation dtype;
    the weights stay f32, cast per op."""
    sd, hf = _state_and_config(source, config)
    act = _cfgget(hf, "activation_function", "gelu_new")
    if act != "gelu_new":
        raise NotImplementedError(
            f"activation_function={act!r} — the GPT family's gelu is the "
            "tanh approximation (HF 'gelu_new', the GPT-2 default); "
            "importing a different activation would silently change the "
            "model's numerics")
    for flag in ("scale_attn_by_inverse_layer_idx",
                 "reorder_and_upcast_attn"):
        if _cfgget(hf, flag, False):
            raise NotImplementedError(
                f"{flag}=True is not implemented — importing it with "
                "standard attention scaling would silently change the "
                "model's numerics")
    d = _cfgget(hf, "n_embd")
    cfg = GPTConfig(
        vocab_size=_cfgget(hf, "vocab_size"),
        max_seq=_cfgget(hf, "n_positions"),
        d_model=d,
        n_heads=_cfgget(hf, "n_head"),
        n_layers=_cfgget(hf, "n_layer"),
        d_ff=_cfgget(hf, "n_inner") or 4 * d,
        dtype=dtype,
        norm_eps=float(_cfgget(hf, "layer_norm_epsilon", 1e-5)),
    )

    def g(key):
        return _np(sd[key])

    blocks = []
    for i in range(cfg.n_layers):
        p = f"transformer.h.{i}."
        wq, wk, wv = np.split(g(p + "attn.c_attn.weight"), 3, axis=1)
        bq, bk, bv = np.split(g(p + "attn.c_attn.bias"), 3)
        blocks.append({
            "ln1_g": g(p + "ln_1.weight"), "ln1_b": g(p + "ln_1.bias"),
            "wq": wq, "bq": bq, "wk": wk, "bk": bk, "wv": wv, "bv": bv,
            "wo": g(p + "attn.c_proj.weight"),
            "bo": g(p + "attn.c_proj.bias"),
            "ln2_g": g(p + "ln_2.weight"), "ln2_b": g(p + "ln_2.bias"),
            "w1": g(p + "mlp.c_fc.weight"), "b1": g(p + "mlp.c_fc.bias"),
            "w2": g(p + "mlp.c_proj.weight"),
            "b2": g(p + "mlp.c_proj.bias"),
        })
    tree = {
        "wte": g("transformer.wte.weight"),
        "wpe": g("transformer.wpe.weight"),
        "lnf_g": g("transformer.ln_f.weight"),
        "lnf_b": g("transformer.ln_f.bias"),
        "blocks": blocks,
    }
    return cfg, params_from_numpy(tree, cfg, device=device)


def to_hf_gpt2(params, cfg: GPTConfig) -> Dict[str, np.ndarray]:
    """GPT-2-shaped parameters (a :class:`GPT`, or the reference's numpy
    tree) → a ``GPT2LMHeadModel`` state dict of numpy arrays; the inverse
    of :func:`from_hf_gpt2`."""
    if (cfg.norm != "layernorm" or not cfg.tied_readout
            or cfg.mlp != "gelu" or not cfg.use_bias
            or cfg.pos_embedding != "learned"):
        raise ValueError("to_hf_gpt2 exports the GPT-2 option set "
                         "(layernorm, tied readout, gelu MLP, biases, "
                         "learned positions); got "
                         f"norm={cfg.norm!r} tied={cfg.tied_readout} "
                         f"mlp={cfg.mlp!r} use_bias={cfg.use_bias} "
                         f"pos={cfg.pos_embedding!r}")
    t = _tree(params)
    a = np.asarray
    out: Dict[str, np.ndarray] = {
        "transformer.wte.weight": a(t["wte"]),
        "transformer.wpe.weight": a(t["wpe"]),
        "transformer.ln_f.weight": a(t["lnf_g"]),
        "transformer.ln_f.bias": a(t["lnf_b"]),
        "lm_head.weight": a(t["wte"]),
    }
    for i, b in enumerate(t["blocks"]):
        p = f"transformer.h.{i}."
        out[p + "attn.c_attn.weight"] = np.concatenate(
            [a(b["wq"]), a(b["wk"]), a(b["wv"])], axis=1)
        out[p + "attn.c_attn.bias"] = np.concatenate(
            [a(b["bq"]), a(b["bk"]), a(b["bv"])])
        for ours, theirs in (("wo", "attn.c_proj.weight"),
                             ("bo", "attn.c_proj.bias"),
                             ("ln1_g", "ln_1.weight"), ("ln1_b", "ln_1.bias"),
                             ("ln2_g", "ln_2.weight"), ("ln2_b", "ln_2.bias"),
                             ("w1", "mlp.c_fc.weight"),
                             ("b1", "mlp.c_fc.bias"),
                             ("w2", "mlp.c_proj.weight"),
                             ("b2", "mlp.c_proj.bias")):
            out[p + theirs] = a(b[ours])
    return out


def from_hf_llama(source, config=None, dtype: torch.dtype = torch.float32,
                  max_seq: Optional[int] = None, device=None
                  ) -> Tuple[GPTConfig, GPT]:
    """A Llama state dict (or model) → ``(GPTConfig, GPT)`` on ``device``
    (the card unless told otherwise). Fits Llama-architecture
    descendants with the same key scheme and the standard head dim
    (projection biases imported where present, zeros in the empty slots;
    a decoupled ``head_dim`` refused). ``max_seq`` (default
    ``max_position_embeddings``) bounds the context for cache sizing."""
    sd, hf = _state_and_config(source, config)
    d = _cfgget(hf, "hidden_size")
    n_heads = _cfgget(hf, "num_attention_heads")
    tied = bool(_cfgget(hf, "tie_word_embeddings", False))
    scaling = _cfgget(hf, "rope_scaling")
    if scaling is not None:
        raise NotImplementedError(
            f"this checkpoint uses rope_scaling={scaling!r} (Llama-3.1-"
            "style frequency remapping); importing it with plain "
            "rope_theta would silently change the model's numerics — "
            "scaled-rope import is not implemented")
    explicit_hd = _cfgget(hf, "head_dim")
    if explicit_hd is not None and explicit_hd != d // n_heads:
        raise NotImplementedError(
            f"checkpoint declares head_dim={explicit_hd} decoupled from "
            f"hidden_size/num_attention_heads={d // n_heads} — the GPT "
            "family derives head_dim from d_model/n_heads")
    cfg = GPTConfig(
        vocab_size=_cfgget(hf, "vocab_size"),
        max_seq=(max_seq if max_seq is not None
                 else _cfgget(hf, "max_position_embeddings")),
        d_model=d,
        n_heads=n_heads,
        n_layers=_cfgget(hf, "num_hidden_layers"),
        d_ff=_cfgget(hf, "intermediate_size"),
        dtype=dtype,
        pos_embedding="rope",
        rope_base=float(_cfgget(hf, "rope_theta", 10000.0)),
        n_kv_heads=_cfgget(hf, "num_key_value_heads", n_heads),
        mlp="swiglu",
        norm="rmsnorm",
        norm_eps=float(_cfgget(hf, "rms_norm_eps", 1e-5)),
        tied_readout=tied,
        # projection biases (Qwen-style) decided from the state dict
        use_bias=any(".bias" in k for k in sd
                     if ".layers.0.self_attn." in k or ".layers.0.mlp." in k),
    )
    if d % n_heads != 0:
        raise ValueError(f"hidden_size {d} not divisible by "
                         f"num_attention_heads {n_heads}")
    kv_hd = cfg.kv_heads * cfg.head_dim

    def lin(block, ours, key, out_dim):
        """An ``nn.Linear`` weight (out, in) → (in, out); its bias leaf
        under ``use_bias`` only (an empty slot becomes zeros)."""
        block["w" + ours] = _np(sd[key + ".weight"]).T
        if cfg.use_bias:
            block["b" + ours] = (
                _np(sd[key + ".bias"]) if key + ".bias" in sd
                else np.zeros((out_dim,), np.float32))

    blocks = []
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        b: Dict[str, Any] = {
            "ln1_g": _np(sd[p + "input_layernorm.weight"]),
            "ln2_g": _np(sd[p + "post_attention_layernorm.weight"]),
        }
        lin(b, "q", p + "self_attn.q_proj", d)
        lin(b, "k", p + "self_attn.k_proj", kv_hd)
        lin(b, "v", p + "self_attn.v_proj", kv_hd)
        lin(b, "o", p + "self_attn.o_proj", d)
        lin(b, "1", p + "mlp.gate_proj", cfg.d_ff)   # silu path
        lin(b, "3", p + "mlp.up_proj", cfg.d_ff)     # value path
        lin(b, "2", p + "mlp.down_proj", d)
        blocks.append(b)
    tree = {"wte": _np(sd["model.embed_tokens.weight"]),
            "lnf_g": _np(sd["model.norm.weight"]), "blocks": blocks}
    if not tied:
        tree["lm_head"] = _np(sd["lm_head.weight"]).T
    return cfg, params_from_numpy(tree, cfg, device=device)


def to_hf_llama(params, cfg: GPTConfig) -> Dict[str, np.ndarray]:
    """Llama-shaped parameters (a :class:`GPT`, or the reference's numpy
    tree) → a ``LlamaForCausalLM`` state dict of numpy arrays
    (``(out, in)`` Linear layout). Takes the bias-free llama option set
    only: plain Llama has no slots for projection biases."""
    if cfg.norm != "rmsnorm" or cfg.mlp != "swiglu" \
            or cfg.pos_embedding != "rope" or cfg.use_bias:
        raise ValueError("to_hf_llama exports the llama option set "
                         "(rmsnorm, swiglu, rope, bias-free); got "
                         f"norm={cfg.norm!r} mlp={cfg.mlp!r} "
                         f"pos={cfg.pos_embedding!r} "
                         f"use_bias={cfg.use_bias}")
    t = _tree(params)
    a = np.asarray
    out: Dict[str, np.ndarray] = {
        "model.embed_tokens.weight": a(t["wte"]),
        "model.norm.weight": a(t["lnf_g"]),
        "lm_head.weight": (a(t["wte"]) if cfg.tied_readout
                           else a(t["lm_head"]).T),
    }
    for i, b in enumerate(t["blocks"]):
        p = f"model.layers.{i}."
        for ours, theirs in (("wq", "self_attn.q_proj"),
                             ("wk", "self_attn.k_proj"),
                             ("wv", "self_attn.v_proj"),
                             ("wo", "self_attn.o_proj"),
                             ("w1", "mlp.gate_proj"),
                             ("w3", "mlp.up_proj"),
                             ("w2", "mlp.down_proj")):
            out[p + theirs + ".weight"] = a(b[ours]).T
        out[p + "input_layernorm.weight"] = a(b["ln1_g"])
        out[p + "post_attention_layernorm.weight"] = a(b["ln2_g"])
    return out
