"""The port's GPT family and generation against the reference, with the
reference's own weights carried over by ``params_from_numpy``: logits
within 1e-4 in f32, greedy tokens equal, with and without the int8
cache, for the GPT-2 layout and a tiny llama layout (GQA, rope, swiglu,
rmsnorm, untied head)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.models import GPTConfig as JConfig
from byteps_tpu.models import generate as jgen
from byteps_tpu.models.gpt import gpt_forward as j_forward
from byteps_tpu.models.gpt import gpt_init as j_init
from byteps_tpu_torch.models import GPTConfig, params_from_numpy
from byteps_tpu_torch.models import generate as tgen
from byteps_tpu_torch.models.gpt import gpt_forward

torch.set_num_threads(1)

# jitted reference entry points (cfg is hashable and static)
j_forward = jax.jit(j_forward, static_argnums=2)
j_apply = jax.jit(jgen.gpt_apply_cached, static_argnums=3)

LOGIT_TOL = 1e-4
_LLAMA = dict(vocab_size=256, max_seq=64, d_model=64, n_heads=4,
              n_kv_heads=2, n_layers=2, d_ff=128)
CONFIGS = {
    "gpt2": (JConfig.tiny(), GPTConfig.tiny()),
    "llama": (JConfig.llama(**_LLAMA), GPTConfig.llama(**_LLAMA)),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    jcfg, tcfg = CONFIGS[request.param]
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def test_params_carry_every_leaf(model):
    jcfg, tcfg, jp, tp = model
    leaves = dict(tp.named_parameters())
    flat = {k: v for k, v in jp.items() if k != "blocks"}
    for i, b in enumerate(jp["blocks"]):
        flat.update({f"blocks.{i}.{k}": v for k, v in b.items()})
    assert sorted(leaves) == sorted(flat)
    for name, v in flat.items():
        np.testing.assert_array_equal(leaves[name].numpy(), np.asarray(v))
    assert ("w3" in tp["blocks"][0]) == (tcfg.mlp == "swiglu")
    assert tp["blocks"][0].get("ln1_b") is None or tcfg.norm == "layernorm"


def test_gpt_forward_logits_match(model):
    jcfg, tcfg, jp, tp = model
    toks = _tokens((2, 13), seed=1)
    want = np.asarray(j_forward(jp, jnp.asarray(toks), jcfg))
    got = gpt_forward(tp, torch.as_tensor(toks), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(tp(torch.as_tensor(toks)).numpy(), got)


@pytest.mark.parametrize("quant", [False, True])
def test_apply_cached_prefill_then_decode_match(model, quant):
    jcfg, tcfg, jp, tp = model
    toks = _tokens((2, 9), seed=2)
    jc = jgen.init_cache(jcfg, 2, h_loc=jcfg.kv_heads, quant=quant)
    tc = tgen.init_cache(tcfg, 2, quant=quant, device="cpu")
    jl, jc = j_apply(jp, jnp.asarray(toks[:, :8]), jc, jcfg)
    tl, tc = tgen.gpt_apply_cached(tp, torch.as_tensor(toks[:, :8]), tc, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    jl, jc = j_apply(jp, jnp.asarray(toks[:, 8:]), jc, jcfg)
    tl, tc = tgen.gpt_apply_cached(tp, torch.as_tensor(toks[:, 8:]), tc, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert tc.length == int(jc.length) == 9
    if quant:
        # the same keys up to f32 roundoff quantize to the same int8 codes,
        # or to a neighbour where a value sits on a rounding edge
        diff = np.abs(tc.k.numpy().astype(np.int32)
                      - np.asarray(jc.k).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("quant", [False, True])
def test_generate_greedy_tokens_equal(model, quant):
    jcfg, tcfg, jp, tp = model
    prompt = _tokens((2, 7), seed=3)
    want = np.asarray(jgen.make_generate_fn(jcfg, 12, quant_cache=quant)(
        jp, jnp.asarray(prompt), jax.random.PRNGKey(0), 0.0))
    got = tgen.make_generate_fn(tcfg, 12, quant_cache=quant,
                                device="cpu")(tp, prompt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.7), (9, 0.5)])
def test_truncate_matches_reference(top_k, top_p):
    logits = np.random.default_rng(4).standard_normal((3, 256)).astype(
        np.float32)
    logits[0, :4] = logits[0, 4]               # ties at the threshold
    want = np.asarray(jgen.make_truncate(top_k, top_p, 256)(
        jnp.asarray(logits)))
    got = tgen.make_truncate(top_k, top_p, 256)(torch.as_tensor(logits))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_reproducible_and_top1_is_greedy(model):
    jcfg, tcfg, jp, tp = model
    prompt = _tokens((2, 5), seed=5)
    gen = tgen.make_generate_fn(tcfg, 8, device="cpu")

    def sample(seed, fn=gen, temp=0.8):
        return fn(tp, prompt, torch.Generator().manual_seed(seed), temp)

    a, b = sample(1), sample(1)
    torch.testing.assert_close(a, b)
    assert a.min() >= 0 and a.max() < tcfg.vocab_size
    top1 = tgen.make_generate_fn(tcfg, 8, top_k=1, device="cpu")
    torch.testing.assert_close(sample(2, top1), gen(tp, prompt))


def test_guards(model):
    jcfg, tcfg, jp, tp = model
    with pytest.raises(ValueError, match="max_seq"):
        tgen.make_generate_fn(tcfg, tcfg.max_seq, device="cpu")(
            tp, _tokens((1, 4), seed=6))
