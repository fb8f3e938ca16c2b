"""The port's flash-attention backward against the reference: its plain
version ``flash_bwd_torch`` and autograd through the port's
``FlashCore`` Function, held against ``jax.vjp`` of the reference's
``flash_attention_lse`` (its Pallas ``_dq_kernel``/``_dkv_kernel`` in
interpret mode, as the reference's own tests run them on the CPU) and of
its jnp twin ``attention_lse_jnp``. Same numpy inputs and cotangents
(dO and a nonzero lse cotangent) into both.

Tolerances: f32 1e-5 (summation order of ≤ 64-term sums); bf16 2e-2
(dS and P round to bf16 before their products on both sides, the
gradients round to bf16 on output, and the two round at slightly
different values). Shapes stay at ≤ 64 rows: interpret mode is slow.
``DQ_CASES`` are the shapes the tensor-core dq kernel's tiling puts at
risk; the reference's kernels take no S = 17, so that case is held
against its jnp twin.

The CUDA kernels are checked against ``flash_bwd_torch`` on the card by
``chip_smoke.py``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("byteps_tpu.ops.flash_attention")

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_TOL = 2e-2
# (B, Sq, Sk, H, Hkv, D, q_off, k_off)
CASES = {
    "mha": (2, 16, 16, 2, 2, 16, 0, 0),
    "gqa": (2, 16, 32, 4, 2, 16, 16, 0),
    "offsets": (1, 16, 32, 2, 2, 16, 8, 0),
    "dead_rows": (2, 16, 16, 2, 2, 16, 0, 8),     # rows 0..7 see no key
}
# the tensor-core kernels' head dims, across a 64-row tile: 80 rows of a
# whole sequence and an 80-row chunk at position 80, GQA 4:1 (the card
# holds those kernels against these plain versions)
TC_CASES = {
    f"{kind}_d{D}": (1, 80, Sk, 4, 1, D, qo, 0)
    for D in (64, 128)
    for kind, Sk, qo in (("seq80", 80, 0), ("chunk80", 160, 80))
}


# shapes the tensor-core dq kernel's tiling puts at risk (its 64-row
# tiles, 64-key stages and dead-row rule): one partial tile, an offset
# chunk whose first 16 rows see no key (every case carries a nonzero lse
# cotangent), and 8 query heads on one kv head
DQ_CASES = {
    "partial17": (1, 17, 17, 2, 2, 64, 0, 0),
    "dead_offset": (1, 32, 64, 2, 2, 64, 16, 32),
    "gqa8": (1, 32, 32, 8, 1, 64, 0, 0),
}


def _dq_reference(Sq, Sk, D):
    """The reference's Pallas kernels where they take the shape, else
    (S = 17: no 8..256 tiling) its jnp twin, the numerics golden."""
    if jfa.supported(Sq, Sk, D):
        return jfa.flash_attention_lse
    return jax.jit(jfa.attention_lse_jnp, static_argnames="causal")


def _inputs(B, Sq, Sk, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((B, Sq, H, D)).astype(f),
            rng.standard_normal((B, Sk, Hkv, D)).astype(f),
            rng.standard_normal((B, Sk, Hkv, D)).astype(f),
            rng.standard_normal((B, Sq, H, D)).astype(f),    # dO
            rng.standard_normal((B, Sq, H)).astype(f))       # dlse


def _ref_grads(fn, arrs, qo, ko, dtype=jnp.float32, causal=True):
    q, k, v, do = (jnp.asarray(a, dtype) for a in arrs[:4])
    dl = jnp.asarray(arrs[4])
    (o, lse), vjp = jax.vjp(
        lambda q, k, v: fn(q, k, v, qo, ko, causal=causal), q, k, v)
    return [np.asarray(g, np.float32) for g in vjp((do, dl))]


def _port_plain(arrs, qo, ko, dtype=torch.float32, causal=True):
    q, k, v, do = (torch.as_tensor(a).to(dtype) for a in arrs[:4])
    dl = torch.as_tensor(arrs[4])
    o, lse = tfa.attention_lse_torch(q, k, v, qo, ko, causal=causal)
    return [g.float().numpy()
            for g in tfa.flash_bwd_torch(q, k, v, o, lse, do, dl, qo, ko,
                                         causal)]


def _port_autograd(arrs, qo, ko, dtype=torch.float32, causal=True):
    q, k, v = (torch.as_tensor(a).to(dtype).requires_grad_()
               for a in arrs[:3])
    do = torch.as_tensor(arrs[3]).to(dtype)
    dl = torch.as_tensor(arrs[4])
    o, lse = tfa.flash_attention_lse(q, k, v, qo, ko, causal=causal)
    assert type(o.grad_fn).__name__ == "FlashCoreBackward"
    return [g.float().numpy()
            for g in torch.autograd.grad((o, lse), (q, k, v), (do, dl))]


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_pallas_kernels(case, monkeypatch):
    monkeypatch.setenv("BYTEPS_KERNEL_BACKEND", "pallas")
    B, Sq, Sk, H, Hkv, D, qo, ko = CASES[case]
    arrs = _inputs(B, Sq, Sk, H, Hkv, D, seed=len(case))
    want = _ref_grads(jfa.flash_attention_lse, arrs, qo, ko)
    _close(_port_plain(arrs, qo, ko), want, F32_TOL)
    _close(_port_autograd(arrs, qo, ko), want, F32_TOL)
    if case == "dead_rows":
        dq = _port_plain(arrs, qo, ko)[0]
        assert np.all(dq[:, :8] == 0.0)


@pytest.mark.parametrize("case", sorted(TC_CASES))
@pytest.mark.parametrize("causal", [True, False])
def test_tc_head_dims_match_pallas_kernels(case, causal, monkeypatch):
    monkeypatch.setenv("BYTEPS_KERNEL_BACKEND", "pallas")
    B, Sq, Sk, H, Hkv, D, qo, ko = TC_CASES[case]
    arrs = _inputs(B, Sq, Sk, H, Hkv, D, seed=D + Sk)
    want = _ref_grads(jfa.flash_attention_lse, arrs, qo, ko, causal=causal)
    _close(_port_plain(arrs, qo, ko, causal=causal), want, F32_TOL)
    _close(_port_autograd(arrs, qo, ko, causal=causal), want, F32_TOL)


@pytest.mark.parametrize("case", sorted(TC_CASES))
def test_tc_head_dims_bf16_match_pallas_kernels(case, monkeypatch):
    monkeypatch.setenv("BYTEPS_KERNEL_BACKEND", "pallas")
    B, Sq, Sk, H, Hkv, D, qo, ko = TC_CASES[case]
    arrs = _inputs(B, Sq, Sk, H, Hkv, D, seed=D + Sk + 1)
    arrs = [np.asarray(torch.as_tensor(a).bfloat16().float())
            for a in arrs[:4]] + [arrs[4]]
    want = _ref_grads(jfa.flash_attention_lse, arrs, qo, ko,
                      dtype=jnp.bfloat16)
    _close(_port_plain(arrs, qo, ko, dtype=torch.bfloat16), want, BF16_TOL)


@pytest.mark.parametrize("case", sorted(DQ_CASES))
def test_dq_tiling_cases_match_reference(case, monkeypatch):
    monkeypatch.setenv("BYTEPS_KERNEL_BACKEND", "pallas")
    B, Sq, Sk, H, Hkv, D, qo, ko = DQ_CASES[case]
    arrs = _inputs(B, Sq, Sk, H, Hkv, D, seed=Sq + H)
    want = _ref_grads(_dq_reference(Sq, Sk, D), arrs, qo, ko)
    plain = _port_plain(arrs, qo, ko)
    _close(plain, want, F32_TOL)
    _close(_port_autograd(arrs, qo, ko), want, F32_TOL)
    n_dead = max(0, ko - qo)
    assert np.all(plain[0][:, :n_dead] == 0.0)


@pytest.mark.parametrize("case", sorted(DQ_CASES))
def test_dq_tiling_cases_bf16_match_reference(case, monkeypatch):
    monkeypatch.setenv("BYTEPS_KERNEL_BACKEND", "pallas")
    B, Sq, Sk, H, Hkv, D, qo, ko = DQ_CASES[case]
    arrs = _inputs(B, Sq, Sk, H, Hkv, D, seed=Sq + H + 1)
    arrs = [np.asarray(torch.as_tensor(a).bfloat16().float())
            for a in arrs[:4]] + [arrs[4]]
    want = _ref_grads(_dq_reference(Sq, Sk, D), arrs, qo, ko,
                      dtype=jnp.bfloat16)
    _close(_port_plain(arrs, qo, ko, dtype=torch.bfloat16), want, BF16_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_jnp_twin(case):
    B, Sq, Sk, H, Hkv, D, qo, ko = CASES[case]
    arrs = _inputs(B, Sq, Sk, H, Hkv, D, seed=10 + len(case))
    j_lse = jax.jit(jfa.attention_lse_jnp, static_argnames="causal")
    want = _ref_grads(j_lse, arrs, qo, ko)
    _close(_port_autograd(arrs, qo, ko), want, F32_TOL)


@pytest.mark.parametrize("case", ["gqa", "dead_rows"])
def test_bf16_backward_matches_pallas_kernels(case, monkeypatch):
    monkeypatch.setenv("BYTEPS_KERNEL_BACKEND", "pallas")
    B, Sq, Sk, H, Hkv, D, qo, ko = CASES[case]
    arrs = _inputs(B, Sq, Sk, H, Hkv, D, seed=21)
    # round the inputs to bf16 once, identically for both sides
    arrs = [np.asarray(torch.as_tensor(a).bfloat16().float())
            for a in arrs[:4]] + [arrs[4]]
    want = _ref_grads(jfa.flash_attention_lse, arrs, qo, ko,
                      dtype=jnp.bfloat16)
    _close(_port_plain(arrs, qo, ko, dtype=torch.bfloat16), want, BF16_TOL)


def test_missing_cotangents_count_as_zero():
    """Only o feeds the loss: the lse cotangent is None and counts as 0;
    only lse feeds it: dO counts as 0."""
    arrs = _inputs(1, 16, 16, 2, 2, 16, seed=3)
    q, k, v = (torch.as_tensor(a).requires_grad_() for a in arrs[:3])
    do, dl = torch.as_tensor(arrs[3]), torch.as_tensor(arrs[4])
    o, lse = tfa.attention_lse_torch(q.detach(), k.detach(), v.detach(), 0,
                                     0)
    o1, _ = tfa.flash_attention_lse(q, k, v, 0, 0)
    got = torch.autograd.grad((o1 * do).sum(), (q, k, v))
    want = tfa.flash_bwd_torch(q.detach(), k.detach(), v.detach(), o, lse,
                               do, None, 0, 0)
    _close([g.numpy() for g in got], [w.numpy() for w in want], 0)
    _, lse2 = tfa.flash_attention_lse(q, k, v, 0, 0)
    got = torch.autograd.grad((lse2 * dl).sum(), (q, k, v))
    want = tfa.flash_bwd_torch(q.detach(), k.detach(), v.detach(), o, lse,
                               torch.zeros_like(do), dl, 0, 0)
    _close([g.numpy() for g in got], [w.numpy() for w in want], 0)
