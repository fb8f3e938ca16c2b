"""The port's HuggingFace checkpoint bridge
(``byteps_tpu_torch/models/import_hf.py``) against the reference's, on
synthetic state dicts made with numpy (no download, no ``transformers``):

* a GPT-2 state dict (from the reference's ``to_hf_gpt2`` of its tiny
  model), given as numpy, as torch tensors, or as an object with
  ``state_dict()`` and ``config``, imports to the reference's config and
  to its tree leaf for leaf; likewise Llama state dicts: untied with
  GQA, tied, and Qwen-style with q/k/v biases (the o bias slot left
  empty, imported as zeros);
* the exports (``to_hf_gpt2``, ``to_hf_llama``) equal the reference's
  key for key and value for value, and round-trip the state dict;
* the imported llama's logits equal the reference's within 1e-5;
* every refusal of the reference, with its exception type and message.

That the bridge imports no ``transformers`` is held in a fresh process by
``tests/test_torch_boundary.py``."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.models import import_hf as jhf
from byteps_tpu.models.gpt import GPTConfig as JConfig
from byteps_tpu.models.gpt import gpt_forward as j_forward
from byteps_tpu.models.gpt import gpt_init as j_init
from byteps_tpu_torch.models import (from_hf_gpt2, from_hf_llama,
                                     gpt_forward, params_to_numpy,
                                     to_hf_gpt2, to_hf_llama)

torch.set_num_threads(1)
TOL = 1e-5
GPT2_HF = {"vocab_size": 96, "n_positions": 32, "n_embd": 32, "n_head": 4,
           "n_layer": 2, "n_inner": None, "layer_norm_epsilon": 1e-5,
           "activation_function": "gelu_new"}
LLAMA_HF = {"vocab_size": 96, "hidden_size": 32, "num_attention_heads": 4,
            "num_key_value_heads": 2, "num_hidden_layers": 2,
            "intermediate_size": 64, "max_position_embeddings": 48,
            "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
            "tie_word_embeddings": False}


def _jcfg_llama(hf):
    return JConfig.llama(vocab_size=hf["vocab_size"], max_seq=hf[
        "max_position_embeddings"], d_model=hf["hidden_size"],
        n_heads=hf["num_attention_heads"],
        n_kv_heads=hf["num_key_value_heads"],
        n_layers=hf["num_hidden_layers"], d_ff=hf["intermediate_size"],
        norm_eps=hf["rms_norm_eps"], tied_readout=hf["tie_word_embeddings"])


def gpt2_state():
    jcfg = JConfig(vocab_size=96, max_seq=32, d_model=32, n_heads=4,
                   n_layers=2, d_ff=128)
    tree = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(1), jcfg))
    return {k: np.asarray(v) for k, v in jhf.to_hf_gpt2(tree, jcfg).items()}


def llama_state(kind: str):
    hf = dict(LLAMA_HF, tie_word_embeddings=kind == "tied")
    tree = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(2),
                                           _jcfg_llama(hf)))
    sd = {k: np.asarray(v)
          for k, v in jhf.to_hf_llama(tree, _jcfg_llama(hf)).items()}
    if kind == "tied":
        del sd["lm_head.weight"]
    if kind == "qkv_bias":
        rng = np.random.default_rng(3)
        for i in range(hf["num_hidden_layers"]):
            for proj, n in (("q", 32), ("k", 16), ("v", 16)):
                sd[f"model.layers.{i}.self_attn.{proj}_proj.bias"] = (
                    rng.standard_normal(n).astype(np.float32))
    return sd, hf


def _assert_same(cfg, params, jcfg, jtree):
    for f in ("vocab_size", "max_seq", "d_model", "n_heads", "n_layers",
              "d_ff", "pos_embedding", "rope_base", "n_kv_heads", "mlp",
              "norm", "norm_eps", "use_bias", "tied_readout"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    got = params_to_numpy(params)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, jtree))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("source", ["numpy", "torch", "model"])
def test_gpt2_imports_leaf_for_leaf(source):
    sd = gpt2_state()
    jcfg, jtree = jhf.from_hf_gpt2(sd, GPT2_HF)
    if source == "numpy":
        cfg, p = from_hf_gpt2(sd, GPT2_HF, device="cpu")
    else:
        tsd = {k: torch.from_numpy(v.copy()) for k, v in sd.items()}
        if source == "torch":
            cfg, p = from_hf_gpt2(tsd, GPT2_HF, device="cpu")
        else:
            model = types.SimpleNamespace(
                state_dict=lambda: tsd,
                config=types.SimpleNamespace(**GPT2_HF))
            cfg, p = from_hf_gpt2(model, device="cpu")
    _assert_same(cfg, p, jcfg, jtree)


@pytest.mark.parametrize("kind", ["untied_gqa", "tied", "qkv_bias"])
def test_llama_imports_leaf_for_leaf(kind):
    sd, hf = llama_state(kind)
    jcfg, jtree = jhf.from_hf_llama(sd, hf)
    cfg, p = from_hf_llama(sd, hf, device="cpu")
    _assert_same(cfg, p, jcfg, jtree)
    assert cfg.use_bias == (kind == "qkv_bias")
    if kind == "qkv_bias":
        assert not np.asarray(params_to_numpy(p)["blocks"][0]["bo"]).any()


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_exports_equal_reference_and_round_trip(family):
    if family == "gpt2":
        sd = gpt2_state()
        jcfg, jtree = jhf.from_hf_gpt2(sd, GPT2_HF)
        cfg, p = from_hf_gpt2(sd, GPT2_HF, device="cpu")
        got, want = to_hf_gpt2(p, cfg), jhf.to_hf_gpt2(jtree, jcfg)
        from_tree = to_hf_gpt2(params_to_numpy(p), cfg)
    else:
        sd, hf = llama_state("untied_gqa")
        jcfg, jtree = jhf.from_hf_llama(sd, hf)
        cfg, p = from_hf_llama(sd, hf, device="cpu")
        got, want = to_hf_llama(p, cfg), jhf.to_hf_llama(jtree, jcfg)
        from_tree = to_hf_llama(params_to_numpy(p), cfg)
    assert set(got) == set(want) == set(sd) == set(from_tree)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        np.testing.assert_array_equal(got[k], sd[k])
        np.testing.assert_array_equal(from_tree[k], sd[k])


def test_imported_llama_logits_match_reference():
    sd, hf = llama_state("untied_gqa")
    jcfg, jtree = jhf.from_hf_llama(sd, hf)
    cfg, p = from_hf_llama(sd, hf, device="cpu")
    tok = np.random.default_rng(5).integers(0, hf["vocab_size"], (2, 12))
    want = np.asarray(j_forward(jtree, jnp.asarray(tok), jcfg))
    got = gpt_forward(p, torch.from_numpy(tok), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _refusal(case):
    """(port call, reference call) that both must refuse."""
    sd2 = gpt2_state()
    sdl, hf = llama_state("untied_gqa")
    jcfg2, jtree2 = jhf.from_hf_gpt2(sd2, GPT2_HF)
    jcfgl, jtreel = jhf.from_hf_llama(sdl, hf)
    jcfgb, jtreeb = jhf.from_hf_llama(*llama_state("qkv_bias"))
    return {
        "relu": ((from_hf_gpt2, sd2, dict(GPT2_HF,
                                         activation_function="relu")),
                 (jhf.from_hf_gpt2, sd2, dict(GPT2_HF,
                                              activation_function="relu"))),
        "scale_attn": ((from_hf_gpt2, sd2, dict(
            GPT2_HF, scale_attn_by_inverse_layer_idx=True)),
            (jhf.from_hf_gpt2, sd2, dict(
                GPT2_HF, scale_attn_by_inverse_layer_idx=True))),
        "upcast_attn": ((from_hf_gpt2, sd2, dict(
            GPT2_HF, reorder_and_upcast_attn=True)),
            (jhf.from_hf_gpt2, sd2, dict(GPT2_HF,
                                         reorder_and_upcast_attn=True))),
        "bare_state_dict": ((from_hf_gpt2, sd2, None),
                            (jhf.from_hf_gpt2, sd2, None)),
        "rope_scaling": ((from_hf_llama, sdl, dict(
            hf, rope_scaling={"type": "llama3", "factor": 8.0})),
            (jhf.from_hf_llama, sdl, dict(
                hf, rope_scaling={"type": "llama3", "factor": 8.0}))),
        "head_dim": ((from_hf_llama, sdl, dict(hf, head_dim=16)),
                     (jhf.from_hf_llama, sdl, dict(hf, head_dim=16))),
        "export_gpt2_of_llama": ((to_hf_gpt2, jtreel, jcfgl_port(hf)),
                                 (jhf.to_hf_gpt2, jtreel, jcfgl)),
        "export_llama_of_gpt2": ((to_hf_llama, jtree2, gpt2_port_cfg()),
                                 (jhf.to_hf_llama, jtree2, jcfg2)),
        "export_llama_biased": ((to_hf_llama, jtreeb, jcfgl_port(
            hf, use_bias=True)), (jhf.to_hf_llama, jtreeb, jcfgb)),
    }[case]


def jcfgl_port(hf, **kw):
    from byteps_tpu_torch.models import GPTConfig
    return GPTConfig.llama(vocab_size=hf["vocab_size"],
                           max_seq=hf["max_position_embeddings"],
                           d_model=hf["hidden_size"],
                           n_heads=hf["num_attention_heads"],
                           n_kv_heads=hf["num_key_value_heads"],
                           n_layers=hf["num_hidden_layers"],
                           d_ff=hf["intermediate_size"], **kw)


def gpt2_port_cfg():
    from byteps_tpu_torch.models import GPTConfig
    return GPTConfig(vocab_size=96, max_seq=32, d_model=32, n_heads=4,
                     n_layers=2, d_ff=128)


@pytest.mark.parametrize("case", ["relu", "scale_attn", "upcast_attn",
                                  "bare_state_dict", "rope_scaling",
                                  "head_dim", "export_gpt2_of_llama",
                                  "export_llama_of_gpt2",
                                  "export_llama_biased"])
def test_refusals_match_reference(case):
    (fn, a, b), (jfn, ja, jb) = _refusal(case)
    with pytest.raises(Exception) as want:
        jfn(ja, jb)
    kw = {"device": "cpu"} if fn in (from_hf_gpt2, from_hf_llama) else {}
    with pytest.raises(type(want.value)) as got:
        fn(a, b, **kw)
    assert str(got.value) == str(want.value)

