"""Shared plumbing of the model families' parity tests
(``tests/test_torch_{bert,vit,t5,resnet}.py``): one seeded set of inputs
a family, the reference's ``make_<family>_train_step`` on a CPU mesh of
the conftest's devices, and the port's mesh legs as two gloo rank
processes (``tests/helpers/family_rank.py``), run once a test session
(the first xdist worker to need them runs them under a file lock and
leaves their outputs for the others).

The reference's family factories initialize from ``PRNGKey(0)``, so the
port starts from those weights (``*_init(PRNGKey(0), cfg)`` as numpy,
through ``models.convert.tree_from_numpy``). Each leg trains ``STEPS``
steps of AdamW (``optax.adamw(1e-3)`` and the port's ``adamw``) on one
global batch; a leg's outputs are its losses and its parameters
gathered whole, flat in ``jax.tree.leaves`` order (ResNet: its
running statistics too)."""

from __future__ import annotations

import contextlib
import fcntl
import functools
import os
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax

from byteps_tpu.models import bert as jbert
from byteps_tpu.models import resnet as jresnet
from byteps_tpu.models import t5 as jt5
from byteps_tpu.models import vit as jvit
from byteps_tpu.models import train as jtrain
from byteps_tpu.parallel import MeshAxes, make_mesh

HELPERS = Path(__file__).resolve().parent
sys.path.insert(0, str(HELPERS))

from tree_leaves import flat  # noqa: E402,F401

STEPS = 2
TOL = 1e-5
ONEBIT_EF = {"compressor": "onebit", "ef": "vanilla"}
ONEBIT_LOSS_TOL = 1e-4
ONEBIT_OFF_SHARE = 1e-3
RESNET_IMAGE = 17                # odd: every stride-2 "SAME" pads (0, 1)

CFGS = {"bert": jbert.BertConfig.tiny(), "vit": jvit.ViTConfig.tiny(),
        "t5": jt5.T5Config.tiny(), "resnet": jresnet.ResNetConfig.tiny()}
FACTORIES = {"bert": jtrain.make_bert_train_step,
             "vit": jtrain.make_vit_train_step,
             "t5": jtrain.make_t5_train_step,
             "resnet": jtrain.make_resnet_train_step}

#: the port's legs over two gloo ranks: (name, family, mesh, options)
LEGS = [
    ("bert_dp2", "bert", {"dp": 2}, {}),
    ("bert_dp2_onebit", "bert", {"dp": 2},
     {"compression_params": ONEBIT_EF}),
    ("bert_dp2_accum", "bert", {"dp": 2}, {"accum_steps": 2}),
    ("bert_tp2_vocab", "bert", {"tp": 2}, {"chunked_ce": "vocab_parallel"}),
    ("bert_sp2", "bert", {"sp": 2}, {}),
    ("bert_dp2_zero1_remat", "bert", {"dp": 2},
     {"zero_1": True, "remat": True}),
    ("vit_dp2", "vit", {"dp": 2}, {}),
    ("vit_tp2", "vit", {"tp": 2}, {}),
    ("t5_dp2", "t5", {"dp": 2}, {}),
    ("t5_tp2", "t5", {"tp": 2}, {}),
    ("t5_sp2", "t5", {"sp": 2}, {}),
    ("resnet_dp2", "resnet", {"dp": 2}, {}),
    ("resnet_slice2", "resnet", {"slice_": 2}, {}),
]


INITS = {"bert": jbert.bert_init, "vit": jvit.vit_init, "t5": jt5.t5_init,
         "resnet": jresnet.resnet_init}


@functools.lru_cache(maxsize=None)
def family_tree(family: str):
    """``family``'s reference weights from ``PRNGKey(0)`` as numpy
    (ResNet: ``(params, bn_state)``)."""
    init = jax.jit(INITS[family], static_argnums=1)
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0),
                                         CFGS[family]))


def trees() -> dict:
    return {fam: family_tree(fam) for fam in CFGS}


def batches() -> dict:
    """Each family's global batch of 4 rows. BERT's mask counts differ
    row by row (2, 8, 4 and 6 of 16), so microbatches weigh unequally;
    T5's source has 16 tokens and its target 8."""
    rng = np.random.default_rng(11)
    V = CFGS["bert"].vocab_size
    tgt = rng.integers(0, V, (4, 16))
    mask = np.zeros((4, 16), np.int32)
    for r, n in enumerate((2, 8, 4, 6)):
        mask[r, rng.choice(16, n, replace=False)] = 1
    tok = np.where(mask == 1, V - 1, tgt)
    # T5's target half the source's length: the cross ring's blocks are
    # rectangular under sp
    src = rng.integers(0, CFGS["t5"].vocab_size, (4, 16))
    tg = rng.integers(0, CFGS["t5"].vocab_size, (4, 9))
    tg[:, 0] = 0
    return {
        "bert": (tok, tgt, mask),
        "vit": (rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
                rng.integers(0, CFGS["vit"].n_classes, (4,))),
        "t5": (src, tg[:, :-1], tg[:, 1:]),
        "resnet": (rng.standard_normal(
            (4, RESNET_IMAGE, RESNET_IMAGE, 3)).astype(np.float32),
            rng.integers(0, CFGS["resnet"].num_classes, (4,))),
    }


def j_mesh(axes: dict):
    total = int(np.prod(list(axes.values()))) if axes else 1
    return make_mesh(MeshAxes(**axes), devices=jax.devices()[:total])


def ref_run(family: str, axes: dict, steps: int = STEPS, **kw) -> dict:
    """The reference's step of ``family`` on the mesh of ``axes`` from
    ``PRNGKey(0)`` weights on the family's batch: losses, flat params
    (and ``bn`` for ResNet)."""
    out = FACTORIES[family](CFGS[family], j_mesh(axes), optax.adamw(1e-3),
                            **kw)
    batch = batches()[family]
    if family == "resnet":
        step, params, opt, bn, bsh = out
    else:
        step, params, opt, bsh = out
    args = [jax.device_put(jnp.asarray(b), bsh) for b in batch]
    losses = []
    for _ in range(steps):
        if family == "resnet":
            loss, params, opt, bn = step(params, opt, bn, *args)
        else:
            loss, params, opt = step(params, opt, *args)
        losses.append(float(loss))
    res = {"loss": np.array(losses),
           "params": flat(jax.tree.map(np.asarray, params))}
    if family == "resnet":
        res["bn"] = flat(jax.tree.map(np.asarray, bn))
    return res


@contextlib.contextmanager
def _locked(path: Path):
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def port_legs(tmp_path_factory) -> list:
    """Each of the two ranks' outputs of :data:`LEGS` (``<leg>_loss``,
    ``<leg>_params``, ``<leg>_bn``), computed once a session across
    xdist workers."""
    base = tmp_path_factory.getbasetemp()
    shared = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    done = shared / "torch_families"
    with _locked(shared / "torch_families.lock"):
        if not (done / "ok").exists():
            done.mkdir(exist_ok=True)
            with open(done / "in.pkl", "wb") as f:
                pickle.dump({"trees": trees(), "batches": batches(),
                             "legs": LEGS, "steps": STEPS}, f)
            from test_torch_ring import run_group

            outs = run_group(done, 2, (HELPERS / "family_rank.py")
                             .read_text(), timeout=300)
            for r, o in enumerate(outs):
                np.savez(done / f"res{r}.npz", **o)
            (done / "ok").write_text("")
    return [dict(np.load(done / f"res{r}.npz")) for r in range(2)]


def off_share(got, want, tol: float = TOL) -> float:
    """Share of elements further apart than ``tol`` (abs + rel)."""
    return float((np.abs(got - want) > tol + tol * np.abs(want)).mean())


#: AdamW divides each gradient by its own running magnitude, so an
#: element whose gradient is roundoff (|g| ~ 1e-9 against a typical 1e-4,
#: where the two frameworks' sums differ by a few percent) moves by a
#: share of lr that differs between them (BERT's tiny raw step: one of
#: 92,224 elements 1.9e-5 apart after two steps, its gradients -1.77e-9
#: and -1.88e-9). Such elements may exceed ``TOL``; at most this share of
#: them, and none by more than lr a step.
ADAM_ROUNDOFF_SHARE = 1e-4
LR = 1e-3


def assert_params_close(got, want, steps: int = STEPS) -> None:
    """Raw training's parameters: within ``TOL`` (abs + rel) but for at
    most ``ADAM_ROUNDOFF_SHARE`` of the elements, which stay within
    ``LR`` a step."""
    assert got.shape == want.shape
    share = off_share(got, want)
    assert share <= ADAM_ROUNDOFF_SHARE, share
    assert np.abs(got - want).max() <= LR * steps
