"""The port's ResNet (``byteps_tpu_torch/models/resnet.py``) and its
SyncBN train step against the reference's, in f32 from the reference's
``PRNGKey(0)`` weights (HWIO convolutions, carried leaf for leaf):

* XLA's "SAME" padding, stride 1 and 2 on even and odd sizes (where
  stride 2 pads the odd pixel after, as ``padding=k//2`` does not), for
  the convolution (1×1, 3×3 and the 7×7 stem) and the 3×3/2 max pool,
  against ``lax.conv_general_dilated`` and ``lax.reduce_window``;
* the layout of ResNet-50 and ResNet-18 (every leaf's shape) equals the
  reference's, and ``ResNetConfig.tiny()``'s tree converts both ways;
* the forward's logits and new running statistics in training and in
  eval mode, and the loss's gradients, within 1e-5;
* ``make_resnet_train_step`` at dp = 1 in this process and at dp = 2
  over two gloo ranks (``tests/helpers/family_parity.py``: 17 × 17
  images, every stride-2 layer padding (0, 1); the batch statistics
  averaged over dp forward and their gradients backward), against the
  reference's dp = 2 step, and on a mesh of two slices (the statistics
  over ``slice_``): the losses, the parameters (but for AdamW's
  roundoff elements, ``family_parity.assert_params_close``) and the
  running statistics within 1e-5, the statistics equal on both ranks."""

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

from byteps_tpu.models import resnet as jresnet  # noqa: E402
from byteps_tpu.models.train import make_resnet_train_step as j_step  # noqa: E402,E501
from byteps_tpu_torch.models import (ResNetConfig, flat_leaves,  # noqa: E402
                                     make_resnet_train_step,
                                     resnet_forward, resnet_loss,
                                     resnet_state_from_numpy,
                                     tree_from_numpy, tree_to_numpy)
from byteps_tpu_torch.models.resnet import (_conv, _max_pool,  # noqa: E402
                                            resnet_layout)

torch.set_num_threads(1)
CFG, JCFG = ResNetConfig.tiny(), CFGS["resnet"]


@pytest.fixture(scope="module")
def tree():
    return family_tree("resnet")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return port_legs(tmp_path_factory)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("n", [16, 17])
@pytest.mark.parametrize("k,stride", [(1, 2), (3, 1), (3, 2), (7, 2)])
def test_same_conv_matches_xla(n, k, stride):
    rng = np.random.default_rng(n * 10 + k)
    x = rng.standard_normal((2, n, n + 1, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 5)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = _conv(_nchw(x), torch.from_numpy(w), stride).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n", [16, 17])
def test_same_max_pool_matches_xla(n):
    x = np.random.default_rng(n).standard_normal(
        (2, n, n + 3, 4)).astype(np.float32)
    want = np.asarray(jax.lax.reduce_window(
        jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
        "SAME"))
    got = _max_pool(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", ["resnet50", "resnet18", "tiny"])
def test_layout_equals_reference(which):
    jcfg = getattr(jresnet.ResNetConfig, which)()
    want = jax.eval_shape(lambda: jresnet.resnet_init(jax.random.PRNGKey(0),
                                                      jcfg))
    p_layout, s_layout = resnet_layout(getattr(ResNetConfig, which)())

    def shapes(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in shapes(t[k])]
        if isinstance(t, list):
            return [x for v in t for x in shapes(v)]
        return [tuple(t[1:])]

    assert shapes(p_layout) + shapes(s_layout) == \
        [tuple(a.shape) for a in jax.tree.leaves(want)]
    assert sorted(p_layout) == sorted(want[0])
    assert sorted(s_layout) == sorted(want[1])


def _port(tree):
    return (tree_from_numpy(tree[0], CFG, device="cpu"),
            resnet_state_from_numpy(tree[1], CFG, device="cpu"))


def test_tree_converts_both_ways(tree):
    p, st = _port(tree)
    np.testing.assert_array_equal(flat(tree_to_numpy(p)), flat(tree[0]))
    np.testing.assert_array_equal(flat(tree_to_numpy(st)), flat(tree[1]))
    assert [t.shape for t in flat_leaves(p)] == \
        [a.shape for a in jax.tree.leaves(tree[0])]
    with pytest.raises(ValueError, match="expects keys"):
        resnet_state_from_numpy(tree[0], CFG, device="cpu")


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_forward_matches_reference(tree, train):
    images, _ = batches()["resnet"]
    jp, js = jax.tree.map(jnp.asarray, tree)
    wl, ws = jax.jit(jresnet.resnet_forward, static_argnums=(3, 4, 5))(
        jp, js, jnp.asarray(images), JCFG, None, train)
    p, st = _port(tree)
    with torch.no_grad():
        gl, gs = resnet_forward(p, st, torch.from_numpy(images), CFG,
                                train=train)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(flat(jax.tree.map(lambda t: t.numpy(), gs)),
                               flat(jax.tree.map(np.asarray, ws)), rtol=TOL,
                               atol=TOL)


def test_loss_grads_match_reference(tree):
    images, labels = batches()["resnet"]
    jp, js = jax.tree.map(jnp.asarray, tree)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda q: jresnet.resnet_loss(q, js, jnp.asarray(images),
                                      jnp.asarray(labels), JCFG),
        has_aux=True))(jp)
    p, st = _port(tree)
    p.requires_grad_(True)
    loss, _ = resnet_loss(p, st, torch.from_numpy(images),
                          torch.from_numpy(labels), CFG)
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= TOL
    for t, w in zip(flat_leaves(p), jax.tree.leaves(jg)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


def test_step_one_rank_matches_reference(tree):
    images, labels = batches()["resnet"]
    step, jp, jo, jbn, bsh = j_step(JCFG, j_mesh({"dp": 1}),
                                    optax.adamw(1e-3))
    args = [jax.device_put(jnp.asarray(b), bsh) for b in (images, labels)]
    want_l = []
    for _ in range(STEPS):
        loss, jp, jo, jbn = step(jp, jo, jbn, *args)
        want_l.append(float(loss))
    p, st = _port(tree)
    s, p, _, bn = make_resnet_train_step(CFG, init_params=p, init_state=st,
                                         device="cpu")
    got_l = [float(s(images, labels)) for _ in range(STEPS)]
    np.testing.assert_allclose(got_l, want_l, rtol=TOL, atol=TOL)
    assert_params_close(np.concatenate([t.detach().numpy().ravel()
                                        for t in flat_leaves(p)]),
                        flat(jax.tree.map(np.asarray, jp)))
    np.testing.assert_allclose(flat(tree_to_numpy(bn)),
                               flat(jax.tree.map(np.asarray, jbn)),
                               rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="needs its init_state"):
        make_resnet_train_step(CFG, init_params=p, device="cpu")


@pytest.mark.parametrize("leg,axes", [("resnet_dp2", {"dp": 2}),
                                      ("resnet_slice2", {"slice_": 2})])
def test_step_two_ranks_matches_reference(port, leg, axes):
    want = ref_run("resnet", axes)
    for rank in port:
        np.testing.assert_allclose(rank[f"{leg}_loss"], want["loss"],
                                   rtol=TOL, atol=TOL)
        assert_params_close(rank[f"{leg}_params"], want["params"])
        np.testing.assert_allclose(rank[f"{leg}_bn"], want["bn"], rtol=TOL,
                                   atol=TOL)
    for key in (f"{leg}_params", f"{leg}_bn"):
        np.testing.assert_array_equal(port[0][key], port[1][key])
