"""The port's ZeRO-1 (``make_gpt_train_step(zero_1=True)``, over
``DistributedOptimizer(zero=True)``) against the reference's, on
``GPTConfig.tiny()`` in f32 from the reference's own weights: the
reference on a dp = n CPU mesh, the port as n gloo rank processes (one
process at n = 1), each rank on its own 4 rows of the global batch,
three steps of AdamW (``optax.adamw(1e-3)`` and the port's ``adamw``).

* raw at n = 1, 2 and 4: losses and parameters within 1e-5, the raw
  training test's bound (the same f32 math in another summation order);
  every rank ends with the same parameters;
* the port against itself: ZeRO-1 raw equals the port's replicated step
  bit for bit at n = 1 and 2 (the sum of two addends does not depend on
  order, AdamW is elementwise, and the stepped segments are gathered as
  values, not as updates added back);
* compressed at n = 2: onebit + EF, with and without Nesterov momentum,
  against the reference under the onebit training test's bounds (losses
  1e-4; the share of parameters off by more than 1e-5 below 1e-3: the
  frameworks reduce the onebit scale in other orders, and a flipped sign
  moves its parameter by about 2·lr); the ring tier bit-equal to the
  staged one; top-k with k = 1.0 equal to plain ZeRO (the idea of the
  reference's ``tests/test_zero.py:87``);
* ``BYTEPS_REDUCE_DTYPE=bfloat16``: the scatter sums in bf16, against the
  reference's: losses at 1e-5; the parameters off by more than 1e-5
  below a share of 1e-3, and each within lr (1e-3) — the frameworks'
  gradients differ by f32 roundoff, so a few elements round to the other
  bf16 neighbour (2 of 87,552 here);
* the moments are ceil(L/n) f32 each on every rank;
* ZeRO-3 (``zero_3=True``) on one rank without a mesh, remat off and
  on, against the reference's ZeRO-3 step on a one-device dp mesh:
  losses and the rebuilt parameters within 1e-5
  (``tests/test_torch_zero3.py`` holds it on several ranks);
* the refusals: ``zero_1`` with ``zero_3``, the zigzag layout without a
  mesh with an sp axis (the reference's ValueError), an unknown layout,
  and a non-elementwise inner optimizer."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from train_parity import (B, JCFG, ONEBIT_EF,  # noqa: E402
                          ONEBIT_LOSS_TOL, ONEBIT_OFF_SHARE, TOL, inputs,
                          mesh, off_share, port_run, ref_run)

from byteps_tpu_torch.models import GPTConfig, make_gpt_train_step  # noqa: E402,E501

torch.set_num_threads(1)
NESTEROV = {**ONEBIT_EF, "momentum": "nesterov"}
BF16_OFF_SHARE = 1e-3
BF16_FLIP_ATOL = 1e-3          # AdamW's lr: one step's update
LEGS = {
    1: [{"name": "zero", "kw": {"zero_1": True}},
        {"name": "replicated", "kw": {}}],
    2: [{"name": "zero", "kw": {"zero_1": True}},
        {"name": "replicated", "kw": {}},
        {"name": "onebit", "kw": {"zero_1": True,
                                  "compression_params": ONEBIT_EF}},
        {"name": "onebit_ring", "kw": {"zero_1": True,
                                       "compression_params": ONEBIT_EF},
         "env": {"BYTEPS_ICI_TIER": "ring"}},
        {"name": "nesterov", "kw": {"zero_1": True,
                                    "compression_params": NESTEROV}},
        {"name": "topk1", "kw": {"zero_1": True, "compression_params":
                                 {"compressor": "topk", "k": 1.0}}},
        {"name": "bf16", "kw": {"zero_1": True},
         "env": {"BYTEPS_REDUCE_DTYPE": "bfloat16"}}],
    4: [{"name": "zero", "kw": {"zero_1": True}}],
}


@pytest.fixture(scope="module")
def data():
    return inputs()


@pytest.fixture(scope="module")
def port(tmp_path_factory, data):
    """{n: each rank's outputs}, each n run once."""
    runs = {}

    def get(n):
        if n not in runs:
            runs[n] = port_run(tmp_path_factory.mktemp(f"zero{n}"), data, n,
                               LEGS[n])
        return runs[n]
    return get


@pytest.mark.parametrize("n", [1, 2, 4])
def test_zero_raw_matches_reference(data, port, n):
    jl, jp = ref_run(data, n, zero_1=True)
    outs = port(n)
    for o in outs:
        np.testing.assert_allclose(o["zero_loss"], jl, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(o["zero_params"], jp, rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(o["zero_params"],
                                      outs[0]["zero_params"])
    assert outs[0]["zero_loss"][-1] < outs[0]["zero_loss"][0]


@pytest.mark.parametrize("n", [1, 2])
def test_zero_raw_equals_replicated_bit_for_bit(port, n):
    for o in port(n):
        np.testing.assert_array_equal(o["zero_loss"], o["replicated_loss"])
        np.testing.assert_array_equal(o["zero_params"],
                                      o["replicated_params"])


@pytest.mark.parametrize("leg", ["onebit", "nesterov"],
                         ids=["ef", "ef-nesterov"])
def test_zero_onebit_matches_reference(data, port, leg):
    comp = ONEBIT_EF if leg == "onebit" else NESTEROV
    jl, jp = ref_run(data, 2, zero_1=True, compression_params=comp)
    outs = port(2)
    total = jp.size
    for o in outs:
        np.testing.assert_allclose(o[f"{leg}_loss"], jl,
                                   rtol=ONEBIT_LOSS_TOL,
                                   atol=ONEBIT_LOSS_TOL)
        assert off_share(o[f"{leg}_params"], jp) < ONEBIT_OFF_SHARE
        # error feedback stays full-length on each rank
        assert o[f"{leg}_ef"].shape == (total,)
        np.testing.assert_array_equal(o[f"{leg}_params"],
                                      outs[0][f"{leg}_params"])
    assert outs[0][f"{leg}_loss"][-1] < outs[0][f"{leg}_loss"][0]
    # compressed: not the raw trajectory
    assert not np.array_equal(outs[0][f"{leg}_params"],
                              outs[0]["zero_params"])
    assert not np.array_equal(outs[0]["onebit_ef"], outs[1]["onebit_ef"])


def test_zero_ring_tier_equals_staged(port):
    for o in port(2):
        for k in ("loss", "params", "ef"):
            np.testing.assert_array_equal(o[f"onebit_ring_{k}"],
                                          o[f"onebit_{k}"])


def test_zero_topk_k1_equals_plain_zero(port):
    for o in port(2):
        np.testing.assert_array_equal(o["topk1_loss"], o["zero_loss"])
        np.testing.assert_array_equal(o["topk1_params"], o["zero_params"])


def test_zero_bf16_reduce_matches_reference(data, port, monkeypatch):
    from byteps_tpu.common.config import reset_config as r_reset

    monkeypatch.setenv("BYTEPS_REDUCE_DTYPE", "bfloat16")
    r_reset()
    try:
        jl, jp = ref_run(data, 2, zero_1=True)
    finally:
        monkeypatch.delenv("BYTEPS_REDUCE_DTYPE")
        r_reset()
    for o in port(2):
        np.testing.assert_allclose(o["bf16_loss"], jl, rtol=TOL, atol=TOL)
        # the frameworks' f32 gradients agree to roundoff, so a few round
        # to the other side of a bf16 tie: one bf16 ulp on one element,
        # which moves its parameter by at most about a step's update (lr)
        assert off_share(o["bf16_params"], jp) < BF16_OFF_SHARE
        np.testing.assert_allclose(o["bf16_params"], jp, rtol=0,
                                   atol=BF16_FLIP_ATOL)
        # the sums were rounded to bf16: not the f32 scatter's parameters
        assert not np.array_equal(o["bf16_params"], o["zero_params"])


@pytest.mark.parametrize("n", [1, 2, 4])
def test_zero_moments_are_one_segment_per_rank(port, n):
    for o in port(n):
        total = o["zero_params"].size
        seg = -(-total // n)
        np.testing.assert_array_equal(o["zero_moments"], [seg, seg])
        assert int(o["zero_moment_bytes"]) == 2 * seg * 4
        if "replicated_moment_bytes" in o:       # n = 1, 2
            assert int(o["replicated_moment_bytes"]) == 2 * total * 4


@pytest.mark.parametrize("remat", [False, True])
def test_zero3_matches_reference_at_one_rank(data, remat):
    import jax
    import jax.numpy as jnp
    import optax

    from byteps_tpu.models.train import make_gpt_train_step as j_step
    from byteps_tpu.parallel.zero3 import zero3_gather_params as j_gather
    from byteps_tpu_torch.models import flat_leaves, params_from_numpy
    from byteps_tpu_torch.parallel.zero3 import zero3_gather_params

    tree, tok, tgt = data[:3]
    step, segs, opt_state, bsh = j_step(
        JCFG, mesh(1, zero_1=True), optax.adamw(1e-3), zero_3=True,
        remat=remat, init_params=jax.tree.map(jnp.array, tree))
    a, b = jax.device_put(tok[:B], bsh), jax.device_put(tgt[:B], bsh)
    jl = []
    for _ in range(3):
        loss, segs, opt_state = step(segs, opt_state, a, b)
        jl.append(float(loss))
    jp = np.concatenate([np.asarray(x).ravel() for x in jax.tree.leaves(
        j_gather(jax.tree.map(np.asarray, segs), JCFG))])
    cfg = GPTConfig.tiny()
    z, tsegs, _ = make_gpt_train_step(
        cfg, init_params=params_from_numpy(tree, cfg, device="cpu"),
        device="cpu", zero_3=True, remat=remat)
    losses = [float(z(tok[:B], tgt[:B])) for _ in range(3)]
    whole = {"rest": tsegs["rest"].detach(),
             "blocks": [t.detach() for t in tsegs["blocks"]]}
    got = np.concatenate([t.numpy().ravel() for t in flat_leaves(
        zero3_gather_params(whole, cfg))])
    np.testing.assert_allclose(losses, jl, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, jp, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kw,exc,match", [
    ({"zero_1": True, "zero_3": True}, ValueError, "mutually exclusive"),
    ({"seq_layout": "zigzag"}, ValueError,
     "requires a mesh with an sp axis"),
    ({"seq_layout": "spiral"}, ValueError, "unknown seq_layout"),
    ({"zero_1": True, "make_optimizer": lambda l: torch.optim.LBFGS(l)},
     ValueError, "elementwise"),
], ids=["zero1-zero3", "zigzag", "unknown-layout", "lbfgs"])
def test_refusals(kw, exc, match):
    with pytest.raises(exc, match=match):
        make_gpt_train_step(GPTConfig.tiny(), device="cpu", **kw)
