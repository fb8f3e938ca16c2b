"""The port's segmented LoRA delta (``ops/segmented_lora.py``) against
the reference's (``byteps_tpu/ops/segmented_lora.py``) on the same numpy
slabs and slots.

f32: the plain version against the reference's jnp twin ``_delta_jnp``
within 1e-6 (the same function, summed in another order). bf16: the
port computes the Pallas body's function (f32 upcast dots, cast out),
which the twin does not (it rounds the slabs and ``u`` to bf16), so it is
held against that body written out with jnp here: the reference's
``_delta_pallas`` passes no ``interpret=True`` and does not run on a CPU.
Slot-0 rows are exactly zero, a slot out of range raises, and a row's
delta does not depend on the batch around it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.ops.segmented_lora import _delta_jnp
from byteps_tpu_torch.ops import _build
from byteps_tpu_torch.ops.segmented_lora import (
    delta_torch,
    segmented_lora_delta,
)

torch.set_num_threads(1)
TOL = 1e-6


def _slabs(rng, n_slots, d_in, rb, d_out):
    """Pool-like slabs: slot 0 all zero, the rest N(0, 1) / N(0, 0.1)."""
    a = rng.standard_normal((n_slots, d_in, rb)).astype(np.float32)
    b = (0.1 * rng.standard_normal((n_slots, rb, d_out))).astype(np.float32)
    a[0] = 0.0
    b[0] = 0.0
    return a, b


def _port(x, a, b, slots, dtype=torch.float32):
    return segmented_lora_delta(torch.as_tensor(x).to(dtype),
                                torch.as_tensor(a), torch.as_tensor(b),
                                torch.as_tensor(slots, dtype=torch.int32))


def _pallas_body(x, a, b, slots):
    """The reference kernel body's arithmetic (segmented_lora.py:87-93),
    one row at a time: f32 upcast, f32 dots, cast to x's dtype."""
    rows = []
    for r in range(x.shape[0]):
        xv = x[r].astype(jnp.float32)
        u = jnp.dot(xv, a[slots[r]], preferred_element_type=jnp.float32)
        rows.append(jnp.dot(u, b[slots[r]],
                            preferred_element_type=jnp.float32
                            ).astype(x.dtype))
    return jnp.stack(rows)


@pytest.mark.parametrize("S", [1, 7, 17])
@pytest.mark.parametrize("rb,d_in", [(4, 48), (8, 48), (1, 48), (3, 48),
                                     (33, 36)],
                         ids=["4", "8", "1", "3", "33-d_in36"])
def test_plain_matches_reference_twin_f32(S, rb, d_in):
    rng = np.random.default_rng(10 * S + rb)
    n_slots, d_out = 5, 80
    a, b = _slabs(rng, n_slots, d_in, rb, d_out)
    # slot 0, repeats and every slot
    slots = np.array([0, 3, 1, 3, 2, 4, 0, 1], np.int32)
    x = rng.standard_normal((len(slots), S, d_in)).astype(np.float32)
    want = np.asarray(_delta_jnp(jnp.asarray(x), jnp.asarray(a),
                                 jnp.asarray(b), jnp.asarray(slots)))
    got = _port(x, a, b, slots).numpy()
    assert got.shape == (len(slots), S, d_out) and got.dtype == np.float32
    # the rank sum's roundoff grows with its terms: above rank 8 the
    # absolute allowance grows with the rank (33 terms of |u_j b_j| ~ 0.6)
    atol = TOL * max(1.0, rb / 8)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=atol)


@pytest.mark.parametrize("S,rb,d_in", [
    pytest.param(1, 8, 64, id="1"), pytest.param(7, 8, 64, id="7"),
    pytest.param(17, 8, 64, id="17"), pytest.param(1, 1, 64, id="1-rank1"),
    pytest.param(7, 3, 64, id="7-rank3"),
    pytest.param(17, 33, 36, id="17-rank33-d_in36")])
def test_bf16_follows_the_pallas_body(S, rb, d_in):
    rng = np.random.default_rng(20 + S if rb == 8 else 20 + S + rb)
    a, b = _slabs(rng, 4, d_in, rb, 96)
    slots = np.array([2, 0, 3, 3, 1], np.int32)
    x = rng.standard_normal((5, S, d_in)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(_pallas_body(xb, jnp.asarray(a), jnp.asarray(b),
                                   slots).astype(jnp.float32))
    got = _port(np.array(xb.astype(jnp.float32)), a, b, slots,
                torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # both round one f32 result to bf16: at most one bf16 ulp apart
    ulp = np.spacing(np.abs(want).astype(np.float32)) * 2 ** 16
    assert (np.abs(got.float().numpy() - want) <= ulp + 1e-30).all()
    # and the twin is another function in bf16: it rounds u to bf16
    twin = np.asarray(_delta_jnp(xb, jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(slots)).astype(jnp.float32))
    assert not np.array_equal(twin, want)


def test_slot_zero_rows_are_exactly_zero():
    rng = np.random.default_rng(3)
    a, b = _slabs(rng, 3, 32, 4, 40)
    slots = np.array([0, 2, 0, 1], np.int32)
    x = 100.0 * rng.standard_normal((4, 3, 32)).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        got = _port(x, a, b, slots, dtype)
        assert (got[slots == 0] == 0).all()
        assert (got[slots != 0] != 0).any()


def test_slot_out_of_range_raises():
    rng = np.random.default_rng(4)
    a, b = _slabs(rng, 3, 16, 4, 16)
    x = rng.standard_normal((2, 1, 16)).astype(np.float32)
    for bad in ([0, 3], [-1, 1]):
        with pytest.raises(ValueError, match="slots must lie"):
            _port(x, a, b, np.array(bad, np.int32))
    with pytest.raises(ValueError, match="pair up"):
        _port(x, a, b, np.zeros(3, np.int32))


def _check_batch_invariant(S, rb, d_in, seed):
    rng = np.random.default_rng(seed)
    a, b = _slabs(rng, 6, d_in, rb, 64)
    slots = np.array([1, 5, 0, 2, 5, 3, 4, 1, 2, 0, 3, 4], np.int32)
    x = rng.standard_normal((12, S, d_in)).astype(np.float32)
    for dtype in (torch.float32, torch.bfloat16):
        full = _port(x, a, b, slots, dtype)
        for r in (0, 4, 11):
            alone = _port(x[r:r + 1], a, b, slots[r:r + 1], dtype)
            assert torch.equal(alone[0], full[r])
            one_slot = _port(x[r:r + 1], a[slots[r]][None],
                             b[slots[r]][None], np.zeros(1, np.int32), dtype)
            assert torch.equal(one_slot[0], full[r])
            for lo, hi in ((0, 1), (2, 6), (S - 1, S)):
                part = _port(x[r:r + 1, lo:hi], a, b, slots[r:r + 1], dtype)
                assert torch.equal(part[0], full[r, lo:hi])


def test_rows_are_batch_invariant():
    """A row's delta is bit for bit the same alone, in any batch and in
    any chunk of its positions: what keeps pooled tokens equal to solo
    ones."""
    _check_batch_invariant(9, 8, 64, 5)


@pytest.mark.parametrize("S,rb,d_in", [(17, 1, 64), (17, 3, 36),
                                        (9, 33, 36)])
def test_rows_are_batch_invariant_at_other_widths(S, rb, d_in):
    """The same at ranks 1, 3 and 33, d_in 36 and 17 positions."""
    _check_batch_invariant(S, rb, d_in, 5 + S + rb)


def test_layer_slice_of_pool_slabs():
    """The decode step hands the kernel a layer's strided slice of the
    pool's (n_slots, L, d_in, rb) slab as it is; the result equals the
    contiguous copy's, and the slice passes the kernel's layout check."""
    from byteps_tpu_torch.ops.segmented_lora import _slab_ok

    rng = np.random.default_rng(6)
    L, n_slots, d_in, rb, d_out = 3, 4, 32, 4, 48
    a = torch.as_tensor(rng.standard_normal((n_slots, L, d_in, rb),
                                            np.float32))
    b = torch.as_tensor(rng.standard_normal((n_slots, L, rb, d_out),
                                            np.float32))
    slots = torch.tensor([3, 0, 1], dtype=torch.int32)
    x = torch.as_tensor(rng.standard_normal((3, 1, d_in), np.float32))
    for li in range(L):
        sa, sb = a[:, li], b[:, li]
        assert not sa.is_contiguous() and _slab_ok(sa) and _slab_ok(sb)
        assert torch.equal(segmented_lora_delta(x, sa, sb, slots),
                           delta_torch(x, sa.contiguous(), sb.contiguous(),
                                       slots))


def test_cpu_tensors_never_touch_the_kernel_build(monkeypatch):
    def refuse(name):
        raise AssertionError(f"CPU call tried to load kernel {name}")

    monkeypatch.setattr(_build, "load", refuse)
    rng = np.random.default_rng(7)
    a, b = _slabs(rng, 3, 16, 4, 16)
    x = rng.standard_normal((2, 2, 16)).astype(np.float32)
    assert _port(x, a, b, np.array([1, 2], np.int32)).shape == (2, 2, 16)


def test_plain_version_is_differentiable_on_cpu():
    rng = np.random.default_rng(8)
    a, b = _slabs(rng, 3, 16, 4, 12)
    x = torch.as_tensor(rng.standard_normal((2, 3, 16), np.float32))
    ta = torch.as_tensor(a).requires_grad_()
    out = segmented_lora_delta(x, ta, torch.as_tensor(b),
                               torch.tensor([1, 2], dtype=torch.int32))
    out.sum().backward()
    assert ta.grad.shape == ta.shape and (ta.grad[0] == 0).all()
