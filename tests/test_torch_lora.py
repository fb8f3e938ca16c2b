"""The port's LoRA adapters (``byteps_tpu_torch/models/lora.py``) against
the reference's (``byteps_tpu/models/lora.py``) on the same numpy
adapters and weights: graft and pool slabs exactly, merge and the
forward delta (outside any ``shard_map``) within 1e-6 of max |ref|, and greedy
tokens of a solo ``make_generate_fn`` run on a grafted tree equal to the
reference's. The reference's LoRA *training* fails on this image
(ROADMAP C.3); its forward and grafted decoding are the oracle here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.models import GPTConfig as JConfig
from byteps_tpu.models import lora as jlora
from byteps_tpu.models.generate import make_generate_fn as j_make_generate
from byteps_tpu.models.gpt import gpt_forward as j_forward
from byteps_tpu.models.gpt import gpt_init as j_init
from byteps_tpu_torch.models import (
    GPTConfig,
    adapters_from_numpy,
    adapters_to_numpy,
    gpt_forward,
    make_generate_fn,
    params_from_numpy,
)
from byteps_tpu_torch.models.generate import gpt_apply_cached, init_cache
from byteps_tpu_torch.models.lora import (
    ALL_TARGETS,
    _check_targets,
    graft_lora,
    lora_delta,
    lora_init,
    lora_pool_slabs,
    lora_rank,
    merge_lora,
)

torch.set_num_threads(1)
CFG = GPTConfig.tiny()
JCFG = JConfig.tiny()
SWIGLU = dict(vocab_size=256, max_seq=64, d_model=64, n_heads=4,
              n_kv_heads=2, n_layers=2, d_ff=128)


def np_adapter(seed, cfg, rank, targets=("wq", "wv"), b_scale=0.5):
    """A reference-shaped adapter tree of numpy arrays with a NONZERO b,
    so the delta changes outputs."""
    rng = np.random.default_rng(seed)
    blocks = []
    for _ in range(cfg.n_layers):
        blk = {}
        for t in targets:
            d_in, d_out = jlora._target_dims(cfg, t)
            blk[t] = {
                "a": (rng.standard_normal((d_in, rank)) / rank ** 0.5
                      ).astype(np.float32),
                "b": (b_scale * rng.standard_normal((rank, d_out))
                      ).astype(np.float32),
            }
        blocks.append(blk)
    return {"blocks": blocks}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def assert_close(got, want, tol=1e-6):
    """|got - want| within ``tol`` of max |want|: the two sum the same
    terms in other orders."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


@pytest.fixture(scope="module")
def weights():
    jp = j_init(jax.random.PRNGKey(0), JCFG)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    return jp, tp


def test_graft_matches_reference_and_shares_base_leaves(weights):
    jp, tp = weights
    ad = np_adapter(1, JCFG, 4, ("wq", "wk", "wv", "wo", "w1", "w2"))
    want = jlora.graft_lora(jp, to_jax(ad), 1.5)
    got = graft_lora(tp, adapters_from_numpy(ad, device="cpu"), 1.5)
    assert set(got) == set(want)
    for li, (gb, wb) in enumerate(zip(got["blocks"], want["blocks"])):
        assert set(gb) == set(wb)
        for t, ab in wb["lora"].items():
            for k in ("a", "b"):
                np.testing.assert_array_equal(gb["lora"][t][k].numpy(),
                                              np.asarray(ab[k]))
        # every base leaf is the module's own tensor, not a copy
        for name in tp.blocks[li]._parameters:
            assert gb[name] is tp.blocks[li][name]
    assert got["wte"] is tp["wte"]


def test_pool_slabs_match_reference():
    ad = np_adapter(2, JCFG, 3, ("wq", "wv", "w2"))
    want = jlora.lora_pool_slabs(to_jax(ad), JCFG, 8, 1.5,
                                 ("wq", "wv", "w2"))
    got = lora_pool_slabs(adapters_from_numpy(ad, device="cpu"), CFG, 8,
                          1.5, ("wq", "wv", "w2"))
    for t in ("wq", "wv", "w2"):
        for k in ("a", "b"):
            assert got[t][k].dtype == torch.float32
            np.testing.assert_array_equal(got[t][k].numpy(),
                                          np.asarray(want[t][k]))
        assert (got[t]["a"][..., 3:] == 0).all()     # zero rank padding
    with pytest.raises(ValueError, match="exceeds the pool's rank bucket"):
        lora_pool_slabs(adapters_from_numpy(ad, device="cpu"), CFG, 2, 1.0,
                        ("wq",))
    with pytest.raises(ValueError, match="missing pool target"):
        lora_pool_slabs(adapters_from_numpy(ad, device="cpu"), CFG, 8, 1.0,
                        ("wq", "wk"))


def test_merge_matches_reference(weights):
    jp, tp = weights
    ad = np_adapter(3, JCFG, 4, ("wq", "wo", "w1"))
    want = jlora.merge_lora(jp, to_jax(ad), 2.0)
    got = merge_lora(tp, adapters_from_numpy(ad, device="cpu"), 2.0)
    for gb, wb in zip(got["blocks"], want["blocks"]):
        for t in ("wq", "wo", "w1"):
            assert_close(gb[t].numpy(), wb[t])
    assert got["blocks"][0]["wk"] is tp.blocks[0]["wk"]


@pytest.mark.parametrize("target", ALL_TARGETS[:4] + ("w1", "w2"))
def test_lora_delta_matches_reference(weights, target):
    jp, tp = weights
    ad = np_adapter(4, JCFG, 4, (target,))
    jg = jlora.graft_lora(jp, to_jax(ad), 1.25)
    tg = graft_lora(tp, adapters_from_numpy(ad, device="cpu"), 1.25)
    d_in = jlora._target_dims(JCFG, target)[0]
    x = np.random.default_rng(5).standard_normal((2, 7, d_in)).astype(
        np.float32)
    want = np.asarray(jlora.lora_delta(jnp.asarray(x), jg["blocks"][1],
                                       target))
    got = lora_delta(torch.as_tensor(x), tg["blocks"][1], target)
    assert_close(got.numpy(), want)
    # no adapter for the target (or no graft at all): nothing to add
    other = "wk" if target != "wk" else "wq"
    assert lora_delta(torch.as_tensor(x[..., :64]), tg["blocks"][1],
                      other) is None
    assert lora_delta(torch.as_tensor(x[..., :64]), tp.blocks[1],
                      target) is None


def test_lora_init_shapes_and_statistics():
    cfg = GPTConfig(**SWIGLU, mlp="swiglu")
    ad = lora_init(cfg, 8, ("wq", "wk", "w3", "w2"),
                   generator=torch.Generator().manual_seed(0), device="cpu")
    assert len(ad["blocks"]) == cfg.n_layers and lora_rank(ad) == 8
    for blk in ad["blocks"]:
        assert blk["wq"]["a"].shape == (64, 8)
        assert blk["wq"]["b"].shape == (8, 64)
        assert blk["wk"]["b"].shape == (8, 32)         # GQA: kv heads only
        assert blk["w3"]["b"].shape == (8, 128)
        assert blk["w2"]["a"].shape == (128, 8)
        for ab in blk.values():
            assert ab["a"].dtype == torch.float32
            assert (ab["b"] == 0).all()
    a = torch.cat([ab["a"].reshape(-1) for blk in ad["blocks"]
                   for ab in blk.values()])
    assert abs(float(a.mean())) < 0.02
    assert abs(float(a.var()) - 1 / 8) < 0.01          # N(0, 1/rank)
    with pytest.raises(ValueError, match="rank"):
        lora_init(cfg, 0, device="cpu")


def test_check_targets_errors():
    assert _check_targets(CFG, ["wq", "wv"]) == ("wq", "wv")
    with pytest.raises(ValueError, match="at least one"):
        _check_targets(CFG, ())
    with pytest.raises(ValueError, match="unknown LoRA target"):
        _check_targets(CFG, ("wq", "wz"))
    with pytest.raises(ValueError, match="swiglu"):
        _check_targets(CFG, ("w3",))
    with pytest.raises(ValueError, match="swiglu"):
        lora_init(CFG, 2, ("w3",), device="cpu")


def test_adapters_numpy_round_trip():
    ad = np_adapter(6, JCFG, 2)
    back = adapters_to_numpy(adapters_from_numpy(ad, device="cpu"))
    for bb, ab in zip(back["blocks"], ad["blocks"]):
        for t in ab:
            for k in ("a", "b"):
                np.testing.assert_array_equal(bb[t][k], ab[t][k])


def test_forward_on_graft_matches_reference_and_merge(weights):
    """gpt_forward on a grafted tree equals the reference's within f32
    roundoff and the port's merged tree's; the cached path (prefill
    through gpt_apply_cached) applies the adapters too."""
    jp, tp = weights
    targets = ("wq", "wk", "wv", "wo", "w1", "w2")
    ad = np_adapter(7, JCFG, 4, targets, b_scale=0.05)
    tad = adapters_from_numpy(ad, device="cpu")
    tg = graft_lora(tp, tad, 1.5)
    tok = np.random.default_rng(8).integers(0, 256, (2, 24)).astype(np.int32)
    want = np.asarray(j_forward(jlora.graft_lora(jp, to_jax(ad), 1.5),
                                jnp.asarray(tok), JCFG))
    got = gpt_forward(tg, torch.as_tensor(tok), CFG)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    merged = gpt_forward(merge_lora(tp, tad, 1.5), torch.as_tensor(tok), CFG)
    np.testing.assert_allclose(got.numpy(), merged.numpy(), rtol=2e-5,
                               atol=2e-5)
    base = gpt_forward(tp, torch.as_tensor(tok), CFG)
    assert not torch.allclose(got, base, atol=1e-3)
    cached, _ = gpt_apply_cached(tg, torch.as_tensor(tok),
                                 init_cache(CFG, 2, device="cpu"), CFG)
    np.testing.assert_allclose(cached.numpy(), got.numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("cfg_kw", [{}, dict(SWIGLU, mlp="swiglu",
                                             norm="rmsnorm", use_bias=False,
                                             pos_embedding="rope",
                                             tied_readout=False)],
                         ids=["gpt2", "llama"])
def test_solo_generate_on_graft_emits_reference_tokens(cfg_kw):
    jcfg, tcfg = JConfig(**cfg_kw) if cfg_kw else JCFG, \
        GPTConfig(**cfg_kw) if cfg_kw else CFG
    jp = j_init(jax.random.PRNGKey(1), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    targets = ("wq", "wv", "w1") + (("w3",) if cfg_kw else ())
    ad = np_adapter(9, jcfg, 4, targets)
    jg = jlora.graft_lora(jp, to_jax(ad), 1.0)
    tg = graft_lora(tp, adapters_from_numpy(ad, device="cpu"), 1.0)
    prompt = np.random.default_rng(10).integers(
        0, tcfg.vocab_size, (1, 11)).astype(np.int32)
    want = np.asarray(j_make_generate(jcfg, 12)(
        jg, jnp.asarray(prompt), jax.random.PRNGKey(0), 0.0))
    got = make_generate_fn(tcfg, 12, device="cpu")(tg, prompt).numpy()
    np.testing.assert_array_equal(got, want)
    base = make_generate_fn(tcfg, 12, device="cpu")(tp, prompt).numpy()
    assert not np.array_equal(got, base), "the adapter changed nothing"
