"""The port's ViT (``byteps_tpu_torch/models/vit.py``) and its train step
against the reference's, on ``ViTConfig.tiny()`` in f32 from the
reference's ``PRNGKey(0)`` weights:

* ``patchify`` equals the reference's bit for bit (square and
  rectangular images, several channels);
* the class logits, the loss and every leaf's gradient within 1e-5;
* ``make_vit_train_step`` at dp = 1 in this process and over two gloo
  ranks at dp2 and tp2 (``tests/helpers/family_parity.py``), two steps
  of AdamW: losses within 1e-5, parameters too but for AdamW's roundoff
  elements (``family_parity.assert_params_close``);
* the config's divisibility guard and ``synthetic_vit_batch``."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from family_parity import (CFGS, STEPS, TOL, assert_params_close,  # noqa: E402,E501
                           batches, family_tree, flat, j_mesh, port_legs,
                           ref_run)

from byteps_tpu.models import vit as jvit  # noqa: E402
from byteps_tpu.models.train import make_vit_train_step as j_step  # noqa: E402,E501
from byteps_tpu_torch.models import (ViTConfig, flat_leaves,  # noqa: E402
                                     make_vit_train_step,
                                     synthetic_vit_batch, tree_from_numpy,
                                     vit_forward, vit_loss)
from byteps_tpu_torch.models.vit import patchify  # noqa: E402

torch.set_num_threads(1)
CFG, JCFG = ViTConfig.tiny(), CFGS["vit"]


@pytest.fixture(scope="module")
def tree():
    return family_tree("vit")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return port_legs(tmp_path_factory)


def _params(tree):
    return tree_from_numpy(tree, CFG, device="cpu")


@pytest.mark.parametrize("shape,patch", [((2, 32, 32, 3), 8),
                                         ((1, 48, 32, 5), 16),
                                         ((3, 12, 18, 1), 6)])
def test_patchify_equals_reference(shape, patch):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    want = np.asarray(jvit.patchify(jnp.asarray(x), patch))
    np.testing.assert_array_equal(patchify(torch.from_numpy(x), patch)
                                  .numpy(), want)


def test_logits_loss_and_grads_match_reference(tree):
    images, labels = batches()["vit"]
    jp = jax.tree.map(jnp.asarray, tree)
    want = np.asarray(jvit.vit_forward(jp, jnp.asarray(images), JCFG))
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jvit.vit_loss(
        p, jnp.asarray(images), jnp.asarray(labels), JCFG)))(jp)
    p = _params(tree)
    got = vit_forward(p, torch.from_numpy(images), CFG).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    p.requires_grad_(True)
    loss = vit_loss(p, torch.from_numpy(images), torch.from_numpy(labels),
                    CFG)
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= TOL
    for t, w in zip(flat_leaves(p), jax.tree.leaves(jg)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


def test_step_one_rank_matches_reference(tree):
    batch = batches()["vit"]
    step, params, opt, bsh = j_step(JCFG, j_mesh({"dp": 1}),
                                    optax.adamw(1e-3))
    args = [jax.device_put(jnp.asarray(b), bsh) for b in batch]
    want_l = []
    for _ in range(STEPS):
        loss, params, opt = step(params, opt, *args)
        want_l.append(float(loss))
    s, p, _ = make_vit_train_step(CFG, init_params=_params(tree),
                                  device="cpu")
    got_l = [float(s(*batch)) for _ in range(STEPS)]
    np.testing.assert_allclose(got_l, want_l, rtol=TOL, atol=TOL)
    assert_params_close(np.concatenate([t.detach().numpy().ravel()
                                        for t in flat_leaves(p)]),
                        flat(jax.tree.map(np.asarray, params)))


@pytest.mark.parametrize("leg,axes", [("vit_dp2", {"dp": 2}),
                                      ("vit_tp2", {"tp": 2})])
def test_step_two_ranks_matches_reference(port, leg, axes):
    want = ref_run("vit", axes)
    for rank in port:
        np.testing.assert_allclose(rank[f"{leg}_loss"], want["loss"],
                                   rtol=TOL, atol=TOL)
        assert_params_close(rank[f"{leg}_params"], want["params"])
    np.testing.assert_array_equal(port[0][f"{leg}_params"],
                                  port[1][f"{leg}_params"])


def test_config_guard_and_synthetic_batch():
    with pytest.raises(ValueError, match="not divisible by patch_size"):
        ViTConfig(image_size=30, patch_size=8)
    assert CFG.n_patches == 16 and ViTConfig.base().n_patches == 196
    images, labels = synthetic_vit_batch(torch.Generator().manual_seed(0),
                                         CFG, 5)
    assert images.shape == (5, 32, 32, 3) and images.dtype == torch.float32
    assert labels.shape == (5,) and int(labels.max()) < CFG.n_classes
