"""The port's plain flash-decode against the reference: JAX
``flash_decode`` (its Pallas kernel in interpret mode on the CPU) and
its golden ``attention_lse_jnp(q, K, V, pos, 0)`` over the (dequantized)
cache, as ``tests/test_flash_decode.py`` pins them. Dense and int8
caches, MHA and GQA; f32 at 1e-5, bf16 at 2e-2.

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
