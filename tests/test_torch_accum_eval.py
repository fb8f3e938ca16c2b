"""The port's gradient accumulation (``make_gpt_train_step(accum_steps=)``)
and eval step (``make_eval_step``, ``evaluate_perplexity``) against the
reference's, on ``GPTConfig.tiny()`` in f32 from the reference's own
weights; the reference on a dp = n CPU mesh, the port as n gloo rank
processes (one process at n = 1), each rank on its own 4 rows:

* ``accum_steps=2`` (two microbatches of 2 rows a rank, forward and
  backward one at a time, the unscaled gradients and losses summed and
  divided once) against the reference's at n = 1 and 2, three steps of
  AdamW: losses and parameters within 1e-5 (at n = 1 the reference's
  own ``_accumulating_value_and_grad`` and ``optax.adamw`` outside
  ``shard_map``: its factory fails the scan's type check on a one-device
  mesh under this image's jax); and against the port's own
  full-batch step, within 1e-5 (the microbatch means add in another
  order than the full batch's mean);
* accumulation with ZeRO-1 and onebit + EF at n = 2 against the
  reference: losses within 1e-4 (the onebit training test's bound);
* a batch that the microbatches do not divide raises, with the
  reference's message;
* the eval step's mean NLL (the group mean at n = 2) and the perplexity
  over two batches against the reference's, 1e-5 relative; no batches
  raise ``ValueError``; the perplexity falls after training on one of
  the batches and starts below twice the vocabulary (the reference's
  ``tests/test_models.py:173``)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from train_parity import (B, ONEBIT_EF, ONEBIT_LOSS_TOL,  # noqa: E402
                          ONEBIT_OFF_SHARE, TOL, inputs, off_share,
                          port_run, ref_accum_one_device, ref_eval,
                          ref_leaves, ref_run)

from byteps_tpu_torch.models import (GPTConfig, evaluate_perplexity,  # noqa: E402,E501
                                     flat_leaves, gpt_init, make_eval_step,
                                     make_gpt_train_step)

torch.set_num_threads(1)
ACCUM = 2
LEGS = [{"name": "accum", "kw": {"accum_steps": ACCUM}},
        {"name": "full", "kw": {}},
        {"name": "accum_zero_onebit",
         "kw": {"accum_steps": ACCUM, "zero_1": True,
                "compression_params": ONEBIT_EF}},
        {"name": "eval", "eval": True}]


@pytest.fixture(scope="module")
def data():
    return inputs()


@pytest.fixture(scope="module")
def port(tmp_path_factory, data):
    runs = {}

    def get(n):
        if n not in runs:
            legs = LEGS if n > 1 else [l for l in LEGS
                                       if l["name"] != "accum_zero_onebit"]
            runs[n] = port_run(tmp_path_factory.mktemp(f"accum{n}"), data,
                               n, legs)
        return runs[n]
    return get


@pytest.mark.parametrize("n", [1, 2])
def test_accum_matches_reference(data, port, n):
    jl, jp = (ref_run(data, n, accum_steps=ACCUM) if n > 1
              else ref_accum_one_device(data, ACCUM))
    outs = port(n)
    for o in outs:
        np.testing.assert_allclose(o["accum_loss"], jl, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(o["accum_params"], jp, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(o["accum_params"],
                                      outs[0]["accum_params"])
    assert outs[0]["accum_loss"][-1] < outs[0]["accum_loss"][0]


@pytest.mark.parametrize("n", [1, 2])
def test_accum_equals_full_batch_step(port, n):
    for o in port(n):
        np.testing.assert_allclose(o["accum_loss"], o["full_loss"],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(o["accum_params"], o["full_params"],
                                   rtol=TOL, atol=TOL)


def test_accum_zero_onebit_ef_matches_reference(data, port):
    jl, jp = ref_run(data, 2, accum_steps=ACCUM, zero_1=True,
                     compression_params=ONEBIT_EF)
    outs = port(2)
    for o in outs:
        np.testing.assert_allclose(o["accum_zero_onebit_loss"], jl,
                                   rtol=ONEBIT_LOSS_TOL,
                                   atol=ONEBIT_LOSS_TOL)
        assert off_share(o["accum_zero_onebit_params"], jp) \
            < ONEBIT_OFF_SHARE
        np.testing.assert_array_equal(o["accum_zero_onebit_params"],
                                      outs[0]["accum_zero_onebit_params"])
        seg = -(-jp.size // 2)
        np.testing.assert_array_equal(o["accum_zero_onebit_moments"],
                                      [seg, seg])


def test_indivisible_batch_raises():
    step, _, _ = make_gpt_train_step(
        GPTConfig.tiny(), accum_steps=3,
        generator=torch.Generator().manual_seed(0), device="cpu")
    tok = np.zeros((B, 8), np.int64)
    with pytest.raises(ValueError,
                       match=f"per-device batch {B} not divisible by "
                             "accum_steps=3"):
        step(tok, tok)


@pytest.mark.parametrize("n", [1, 2])
def test_eval_and_perplexity_match_reference(data, port, n):
    jl, jppl = ref_eval(data, n)
    for o in port(n):
        np.testing.assert_allclose(o["eval_loss"], [jl], rtol=TOL)
        np.testing.assert_allclose(o["eval_ppl"], [jppl], rtol=TOL)


def test_perplexity_of_no_batches_raises():
    cfg = GPTConfig.tiny()
    ev = make_eval_step(cfg, device="cpu")
    with pytest.raises(ValueError, match="no batches"):
        evaluate_perplexity(ev, gpt_init(cfg, device="cpu"), [])


def test_perplexity_falls_after_training(data):
    """The reference's ``test_eval_step_and_perplexity``: six Adam(1e-2)
    steps on the first of two batches, then the perplexity over both is
    lower; the untrained model's is near uniform over the vocabulary.
    The eval step takes no gradient."""
    tree, _, _, etok, etgt = data
    cfg = GPTConfig.tiny()
    params = gpt_init(cfg, device="cpu")
    with torch.no_grad():
        for t, a in zip(flat_leaves(params), ref_leaves(tree)):
            t.copy_(torch.from_numpy(a.copy()))
    batches = [(t[:B], g[:B]) for t, g in zip(etok, etgt)]
    ev = make_eval_step(cfg, device="cpu")
    ppl0 = evaluate_perplexity(ev, params, batches)
    step, params, _ = make_gpt_train_step(
        cfg, lambda l: torch.optim.Adam(l, lr=1e-2), init_params=params,
        device="cpu")
    assert all(p.grad is None for p in flat_leaves(params))
    for _ in range(6):
        step(*batches[0])
    ppl1 = evaluate_perplexity(ev, params, batches)
    assert np.isfinite(ppl0) and np.isfinite(ppl1)
    assert ppl1 < ppl0 < cfg.vocab_size * 2
