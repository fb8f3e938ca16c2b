"""The port's plain flash-decode against the reference: JAX
``flash_decode`` (its Pallas kernel in interpret mode on the CPU) and
its golden ``attention_lse_jnp(q, K, V, pos, 0)`` over the (dequantized)
cache, as ``tests/test_flash_decode.py`` pins them. Dense and int8
caches, MHA and GQA; f32 at 1e-5, bf16 at 2e-2. The kernel's split plan
(``decode_plan``) and its merge of per-split partial states in split
order are checked here too, the merge through a torch f32 twin.

The CUDA decode kernel is checked against this plain version on the card
by ``chip_smoke.py``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.models.generate import _quantize_block as j_quantize
from byteps_tpu_torch.models.generate import _quantize_block as t_quantize
from byteps_tpu_torch.ops import flash_decode as tfd

jfa = importlib.import_module("byteps_tpu.ops.flash_attention")
jfd = importlib.import_module("byteps_tpu.ops.flash_decode")
_j_lse = jax.jit(jfa.attention_lse_jnp)

torch.set_num_threads(1)

F32_TOL = 1e-5


def _mk(B, S, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 1, H, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, D)).astype(np.float32))


def _golden(q, k, v, pos):
    o, _ = _j_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, 0)
    return np.asarray(o)


@pytest.mark.parametrize("pos", [0, 5, 31, 32, 63])
def test_dense_matches_reference_kernel_and_golden(pos):
    q, k, v = _mk(2, 64, 4, 4, 32, seed=0)
    got = tfd.flash_decode(*map(torch.as_tensor, (q, k, v)), pos).numpy()
    np.testing.assert_allclose(got, _golden(q, k, v, pos), rtol=F32_TOL,
                               atol=F32_TOL)
    ref = np.asarray(jfd.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.int32(pos)))
    np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("g", [2, 4])
def test_gqa_matches_reference_kernel(g):
    q, k, v = _mk(2, 64, 8, 8 // g, 32, seed=1)
    got = tfd.flash_decode(*map(torch.as_tensor, (q, k, v)), 40).numpy()
    ref = np.asarray(jfd.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.int32(40)))
    np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got, _golden(q, k, v, 40), rtol=F32_TOL,
                               atol=F32_TOL)


def test_int8_cache_matches_reference_kernel_and_golden():
    """Quantization is bit-identical across the packages, and the int8
    decode equals dequantize-then-attend."""
    q, k, v = _mk(2, 64, 4, 2, 32, seed=2)
    jkq, jks = j_quantize(jnp.asarray(k))
    jvq, jvs = j_quantize(jnp.asarray(v))
    tkq, tks = t_quantize(torch.as_tensor(k))
    tvq, tvs = t_quantize(torch.as_tensor(v))
    np.testing.assert_array_equal(tkq.numpy(), np.asarray(jkq))
    np.testing.assert_array_equal(tks.numpy(), np.asarray(jks))
    got = tfd.flash_decode(torch.as_tensor(q), tkq, tvq, 50,
                           k_scale=tks, v_scale=tvs).numpy()
    ref = np.asarray(jfd.flash_decode(jnp.asarray(q), jkq, jvq,
                                      jnp.int32(50), k_scale=jks,
                                      v_scale=jvs))
    np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)
    kd = np.asarray(jkq, np.float32) * np.asarray(jks)[..., None]
    vd = np.asarray(jvq, np.float32) * np.asarray(jvs)[..., None]
    np.testing.assert_allclose(got, _golden(q, kd, vd, 50), rtol=F32_TOL,
                               atol=F32_TOL)


def test_bf16_in_bf16_out():
    q, k, v = _mk(1, 32, 2, 2, 64, seed=3)
    tq, tk, tv = (torch.as_tensor(a).bfloat16() for a in (q, k, v))
    got = tfd.flash_decode(tq, tk, tv, 20)
    assert got.dtype == torch.bfloat16
    ref = jfd.flash_decode(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                             for t in (tq, tk, tv)), jnp.int32(20))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("most", [16, 3, 1])
@pytest.mark.parametrize("sms", [132, 8])
def test_split_plan_covers_the_live_prefix(sms, most):
    """The splits cover keys 0..pos once, in whole 32-key tiles (the last
    one ragged), never past pos; at least one split; and the grid reaches
    a wave of ``sms`` blocks wherever the live tiles allow it within
    ``most`` splits."""
    for live in range(1, 1025):
        tiles = -(-live // 32)
        for B, Hkv in ((1, 1), (1, 16), (2, 4), (4, 16), (8, 16), (8, 4)):
            n, per = tfd.decode_plan(live, B, Hkv, sms, most)
            assert 1 <= n <= most and per >= 1
            ranges = [(s * per * 32, min(live, (s + 1) * per * 32))
                      for s in range(n)]
            assert ranges[0][0] == 0 and ranges[-1][1] == live
            assert all(a < b for a, b in ranges)                 # none empty
            assert all(r[1] == nx[0] for r, nx in zip(ranges, ranges[1:]))
            assert all(b - a == per * 32 for a, b in ranges[:-1])
            most_n = -(-tiles // -(-tiles // most))   # most splits possible
            assert n * B * Hkv >= min(sms, B * Hkv * most_n), (live, B, Hkv)
    assert tfd.decode_plan(1024, 4, 16, 132) == tfd.decode_plan(
        1024, 4, 16, 132)


def _split_merge(q, k, v, pos, n_split, split_tiles):
    """The kernel's arithmetic in torch f32: per split, the partial state
    (m, l, acc) of its keys; split 0 then combines them in split order,
    rescaling the running state to each new maximum."""
    B, _, H, D = q.shape
    G = H // k.shape[2]
    kk, vv = k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)
    live = pos + 1
    mx = torch.full((B, H), -1e30)
    l, acc = torch.zeros(B, H), torch.zeros(B, H, D)
    for s in range(n_split):
        lo, hi = s * split_tiles * 32, min(live, (s + 1) * split_tiles * 32)
        sc = torch.einsum("bhd,bkhd->bhk", q[:, 0], kk[:, lo:hi]) / D ** 0.5
        m_s = sc.amax(-1)
        p = torch.exp(sc - m_s[..., None])
        l_s, a_s = p.sum(-1), torch.einsum("bhk,bkhd->bhd", p, vv[:, lo:hi])
        mn = torch.maximum(mx, m_s)
        old, add = torch.exp(mx - mn), torch.exp(m_s - mn)
        l, acc, mx = l * old + l_s * add, acc * old[..., None] + \
            a_s * add[..., None], mn
    return (acc / l[..., None])[:, None]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("hkv", [4, 2])
@pytest.mark.parametrize("pos", [0, 31, 32, 160, 1023])
def test_split_merge_matches_reference(pos, hkv, quant):
    """Per-split partials merged in split order on the plan the kernel
    takes equal decode_torch and the JAX golden over the same cache (int8
    entries dequantized as the kernel reads them)."""
    q, k, v = _mk(2, 1024, 4, hkv, 32, seed=pos + hkv)
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    ks = vs = None
    if quant:
        tk, ks = t_quantize(tk)
        tv, vs = t_quantize(tv)
    want = tfd.decode_torch(tq, tk, tv, pos, ks, vs)
    kd = tfd._read(tk, ks, torch.float32)
    vd = tfd._read(tv, vs, torch.float32)
    plan = tfd.decode_plan(pos + 1, 2, hkv, 132)
    got = _split_merge(tq, kd, vd, pos, *plan)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(got.numpy(),
                               _golden(q, kd.numpy(), vd.numpy(), pos),
                               rtol=F32_TOL, atol=F32_TOL)


def test_guards():
    q, k, v = (torch.as_tensor(a) for a in _mk(1, 64, 4, 2, 32, seed=4))
    with pytest.raises(ValueError, match="T=1"):
        tfd.flash_decode(torch.cat([q, q], dim=1), k, v, 0)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tfd.flash_decode(q, k[:, :, :1].expand(1, 64, 3, 32), v, 0)
    with pytest.raises(ValueError, match="together"):
        tfd.flash_decode(q, k, v, 0, k_scale=torch.ones(1, 64, 2))
    with pytest.raises(ValueError, match="outside the cache"):
        tfd.flash_decode(q, k, v, 64)
    with pytest.raises(ValueError, match="does not match the cache"):
        tfd.flash_decode(q, k, v, 0, k_scale=torch.ones(1, 63, 2),
                         v_scale=torch.ones(1, 64, 2))
    # one head-dim gate for both kernels
    wide = torch.zeros(1, 8, 1, 512)
    with pytest.raises(ValueError, match="past the kernels' bound"):
        tfd.flash_decode(wide[:, :1], wide, wide, 0)
