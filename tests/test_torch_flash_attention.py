"""The port's plain flash-attention versions against the reference: the
jnp twin ``attention_lse_jnp`` and the Pallas forward kernel in
interpret mode (``BYTEPS_KERNEL_BACKEND=pallas``, as the reference's own
tests run it on the CPU). Same numpy inputs into both; f32 held at
1e-5, bf16 at 2e-2 (the output's rounding plus summation order).

The CUDA kernel itself is checked against these plain versions on the
card by ``chip_smoke.py``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu_torch.ops import flash_attention as tfa

# the reference's ops package re-exports a function of the module's name
jfa = importlib.import_module("byteps_tpu.ops.flash_attention")
j_lse = jax.jit(jfa.attention_lse_jnp, static_argnames="causal")
j_attn = jax.jit(jfa.attention_jnp, static_argnames="causal")

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_TOL = 2e-2
# (B, Sq, Sk, H, Hkv, D, q_off, k_off)
CASES = {
    "plain": (2, 16, 16, 2, 2, 16, 0, 0),
    "offsets": (1, 8, 32, 2, 2, 16, 24, 0),      # chunk at pos 24
    "dead_rows": (2, 16, 16, 2, 2, 16, 0, 8),    # rows 0..7 see no key
    "gqa": (2, 16, 24, 4, 2, 16, 8, 0),
    "gqa4": (1, 24, 40, 8, 2, 32, 16, 0),
}
# the tensor-core kernels' head dims, across a 64-row tile: 80 rows of a
# whole sequence and an 80-row chunk at position 80, GQA 4:1 (the card
# holds those kernels against these plain versions)
TC_CASES = {
    f"{kind}_d{D}": (1, 80, Sk, 4, 1, D, qo, 0)
    for D in (64, 128)
    for kind, Sk, qo in (("seq80", 80, 0), ("chunk80", 160, 80))
}
CASES.update(TC_CASES)
# the serving chunks' geometry across 128-key split boundaries (the card's
# split path merges a row's splits in one cluster): 37 rows at 260 reach
# key 297, 40 rows at 264 key 304, 64 rows at 130 under GQA 4:1 key 194.
# The reference's Pallas forward takes lengths in whole 8-row tiles only,
# so it runs the last two.
SPLIT_CASES = {
    "chunk_splits": (1, 37, 300, 2, 2, 64, 260, 0),
    "chunk40_splits": (1, 40, 304, 2, 2, 64, 264, 0),
    "chunk64_gqa": (1, 64, 200, 4, 1, 64, 130, 0),
}
PALLAS_SPLIT_CASES = ["chunk40_splits", "chunk64_gqa"]
CASES.update(SPLIT_CASES)


def _inputs(B, Sq, Sk, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32))


def _port(fn, arrs, *args, dtype=torch.float32, **kw):
    out = fn(*(torch.as_tensor(a).to(dtype) for a in arrs), *args, **kw)
    if isinstance(out, tuple):
        return tuple(o.float().numpy() for o in out)
    return out.float().numpy()


def _ref(fn, arrs, *args, dtype=jnp.float32, **kw):
    out = fn(*(jnp.asarray(a, dtype) for a in arrs), *args, **kw)
    if isinstance(out, tuple):
        return tuple(np.asarray(o, np.float32) for o in out)
    return np.asarray(out, np.float32)


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("causal", [True, False])
def test_attention_lse_matches_jnp_twin(case, causal):
    B, Sq, Sk, H, Hkv, D, qo, ko = CASES[case]
    arrs = _inputs(B, Sq, Sk, H, Hkv, D, seed=len(case))
    want = _ref(j_lse, arrs, qo, ko, causal=causal)
    got = _port(tfa.attention_lse_torch, arrs, qo, ko, causal=causal)
    _close(got, want, F32_TOL)
    # the dispatcher takes the same plain path for CPU tensors
    _close(_port(tfa.attention_lse, arrs, qo, ko, causal=causal), want,
           F32_TOL)
    if case == "dead_rows" and causal:
        assert np.all(got[0][:, :8] == 0.0)
        assert np.all(got[1][:, :8] == jfa._NEG)


@pytest.mark.parametrize("case", ["offsets", "dead_rows", "gqa",
                                  *PALLAS_SPLIT_CASES])
def test_attention_lse_matches_pallas_forward_kernel(case, monkeypatch):
    monkeypatch.setenv("BYTEPS_KERNEL_BACKEND", "pallas")
    B, Sq, Sk, H, Hkv, D, qo, ko = CASES[case]
    arrs = _inputs(B, Sq, Sk, H, Hkv, D, seed=7)
    want = _ref(jfa.flash_attention_lse, arrs, qo, ko)
    got = _port(tfa.flash_attention_lse, arrs, qo, ko)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("case", sorted(TC_CASES))
@pytest.mark.parametrize("causal", [True, False])
def test_tc_head_dims_match_pallas_forward_kernel(case, causal, monkeypatch):
    monkeypatch.setenv("BYTEPS_KERNEL_BACKEND", "pallas")
    B, Sq, Sk, H, Hkv, D, qo, ko = CASES[case]
    arrs = _inputs(B, Sq, Sk, H, Hkv, D, seed=D + Sk)
    want = _ref(jfa.flash_attention_lse, arrs, qo, ko, causal=causal)
    got = _port(tfa.flash_attention_lse, arrs, qo, ko, causal=causal)
    _close(got, want, F32_TOL)


def test_flash_attention_matches_pallas_and_jnp(monkeypatch):
    monkeypatch.setenv("BYTEPS_KERNEL_BACKEND", "pallas")
    arrs = _inputs(2, 32, 32, 2, 2, 16, seed=3)
    for causal in (True, False):
        want = _ref(jfa.flash_attention, arrs, causal=causal)
        _close([_port(tfa.flash_attention, arrs, causal=causal)], [want],
               F32_TOL)
        _close([_port(tfa.attention_torch, arrs, causal=causal)],
               [_ref(j_attn, arrs, causal=causal)], F32_TOL)


def test_per_row_offsets_match_jnp_twin():
    """The packed-decode contract: a (B,) q_offset vector masks each row
    against its own fill level (always the plain path)."""
    arrs = _inputs(3, 1, 24, 4, 2, 16, seed=5)
    pos = np.array([0, 9, 23], np.int32)
    want = _ref(j_lse, arrs, jnp.asarray(pos), 0)
    got = _port(tfa.attention_lse, arrs, torch.as_tensor(pos), 0)
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("case", ["offsets", "gqa", *sorted(SPLIT_CASES)])
def test_bf16_matches_jnp_twin(case):
    B, Sq, Sk, H, Hkv, D, qo, ko = CASES[case]
    arrs = _inputs(B, Sq, Sk, H, Hkv, D, seed=11)
    # round the inputs to bf16 once, identically for both sides
    arrs = [np.asarray(torch.as_tensor(a).bfloat16().float()) for a in arrs]
    want = _ref(j_lse, arrs, qo, ko, dtype=jnp.bfloat16)
    got = _port(tfa.attention_lse, arrs, qo, ko, dtype=torch.bfloat16)
    _close(got, want, BF16_TOL)


def test_guards_and_support():
    assert tfa.supported(64) and tfa.supported(256) and tfa.supported(1)
    assert not tfa.supported(257) and not tfa.supported(0)
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tfa.flash_attention_lse(q, torch.zeros(1, 8, 3, 16),
                                torch.zeros(1, 8, 3, 16), 0, 0)
    with pytest.raises(ValueError, match="GQA narrows"):
        tfa.flash_attention_lse(q, torch.zeros(1, 8, 2, 16),
                                torch.zeros(1, 8, 4, 16), 0, 0)
    with pytest.raises(ValueError, match="scalar q_offset"):
        tfa.flash_attention_lse(q, q, q, torch.zeros(1, dtype=torch.int32),
                                0)
    # head_dim past the kernel's bound takes the plain path on any device
    arrs = _inputs(1, 4, 4, 1, 1, 300, seed=1)
    _close([_port(tfa.flash_attention, arrs)],
           [_ref(j_attn, arrs)], F32_TOL)
