"""Shared plumbing of the training-option parity tests
(``tests/test_torch_zero.py``, ``tests/test_torch_accum_eval.py``): one
seeded set of inputs, the reference's ``make_gpt_train_step`` on a dp = n
CPU mesh, and the port's legs at n ranks (in this process at n = 1, as
gloo processes at n > 1, through ``tests/helpers/train_rank.py``).

The inputs: the reference's ``GPTConfig.tiny()`` weights from
``PRNGKey(0)``, a global batch of n·B rows (rank r holds rows
``[r·B, (r+1)·B)``, as the reference's dp sharding of the batch), and
two eval batches of the same shape."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax

from byteps_tpu.models import GPTConfig as JConfig
from byteps_tpu.models.gpt import gpt_init as j_init
from byteps_tpu.models.train import evaluate_perplexity as j_perplexity
from byteps_tpu.models.train import make_eval_step as j_eval_step
from byteps_tpu.models.train import make_gpt_train_step as j_train_step
from byteps_tpu.parallel import MeshAxes, make_mesh

HELPERS = Path(__file__).resolve().parent
sys.path.insert(0, str(HELPERS))
import train_rank  # noqa: E402

JCFG = JConfig.tiny()
B, S = 4, 32                     # rows a rank, sequence length
MAX_N = 4
TOL = 1e-5
ONEBIT_LOSS_TOL = 1e-4
ONEBIT_OFF_SHARE = 1e-3
ONEBIT_EF = {"compressor": "onebit", "ef": "vanilla"}


def inputs():
    """(tree, tok, tgt, etok, etgt): numpy weights and MAX_N ranks' rows."""
    tree = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), JCFG))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, JCFG.vocab_size,
                        (3, MAX_N * B, S + 1)).astype(np.int32)
    return tree, toks[0, :, :-1], toks[0, :, 1:], toks[1:, :, :-1], \
        toks[1:, :, 1:]


def mesh(n: int, zero_1: bool = False):
    """The reference's dp = n mesh. At n = 1 ``make_mesh`` gives the one
    device every axis at size 1, ``slice_`` too, which the reference's
    ZeRO-1 refuses: ZeRO-1 takes a dp-only mesh there (on which the
    reference's accumulation fails its scan's type check instead)."""
    if zero_1:
        return jax.make_mesh((n,), ("dp",), devices=jax.devices()[:n])
    return make_mesh(MeshAxes(dp=n), devices=jax.devices()[:n])


def ref_leaves(tree) -> list:
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def ref_run(data, n: int, steps: int = 3, **kw):
    """The reference's step at dp = n (``optax.adamw(1e-3)``) from the
    inputs' weights on the first n·B rows: (losses, flat params)."""
    tree, tok, tgt = data[:3]
    step, params, opt_state, bsh = j_train_step(
        JCFG, mesh(n, kw.get("zero_1", False)), optax.adamw(1e-3),
        init_params=jax.tree.map(jnp.array, tree), **kw)
    a = jax.device_put(tok[:n * B], bsh)
    b = jax.device_put(tgt[:n * B], bsh)
    losses = []
    for _ in range(steps):
        loss, params, opt_state = step(params, opt_state, a, b)
        losses.append(float(loss))
    return losses, np.concatenate([x.ravel() for x in ref_leaves(params)])


def ref_accum_one_device(data, accum_steps: int, steps: int = 3):
    """The reference's dp = 1 accumulating step outside ``shard_map``:
    its own ``_accumulating_value_and_grad`` over ``gpt_loss``, then
    ``optax.adamw(1e-3)`` (the aggregation of one worker is the
    identity). Its factory fails the scan's carry type check on a
    one-device mesh under this image's jax (``jax.make_mesh`` or
    ``make_mesh``), at dp = 2 it runs."""
    import functools

    from byteps_tpu.models.gpt import gpt_loss as j_loss
    from byteps_tpu.models.train import _accumulating_value_and_grad

    tree, tok, tgt = data[:3]
    vag = jax.jit(_accumulating_value_and_grad(
        functools.partial(j_loss, cfg=JCFG), accum_steps))
    tx = optax.adamw(1e-3)
    params = jax.tree.map(jnp.array, tree)
    state = tx.init(params)
    losses = []
    for _ in range(steps):
        loss, grads = vag(params, jnp.asarray(tok[:B]), jnp.asarray(tgt[:B]))
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return losses, np.concatenate([x.ravel() for x in ref_leaves(params)])


def ref_eval(data, n: int):
    """The reference's eval step at dp = n on the first batch, and its
    perplexity over the two eval batches."""
    tree, tok, tgt, etok, etgt = data
    ev, bsh = j_eval_step(JCFG, mesh(n))
    p = jax.tree.map(jnp.array, tree)
    loss = float(ev(p, jax.device_put(tok[:n * B], bsh),
                    jax.device_put(tgt[:n * B], bsh)))
    ppl = j_perplexity(ev, p, [(t[:n * B], g[:n * B])
                               for t, g in zip(etok, etgt)], bsh)
    return loss, ppl


def port_run(io: Path, data, n: int, legs: list) -> list:
    """Each rank's outputs of the port's ``legs`` at n ranks."""
    tree, tok, tgt, etok, etgt = data
    leaves = ref_leaves(tree)
    np.savez(io / "in.npz", tok=tok[:n * B], tgt=tgt[:n * B],
             etok=etok[:, :n * B], etgt=etgt[:, :n * B],
             n_leaves=len(leaves), **{f"p{i}": a for i, a in
                                      enumerate(leaves)})
    (io / "legs.json").write_text(json.dumps(legs))
    if n == 1:
        return [train_rank.run_legs(str(io), 0, 1)]
    from test_torch_ring import run_group

    return run_group(io, n, (HELPERS / "train_rank.py").read_text())


def off_share(got, want, tol: float = TOL) -> float:
    """Share of elements further apart than ``tol`` (abs + rel)."""
    return float((np.abs(got - want) > tol + tol * np.abs(want)).mean())


# --------------------------------------------------------------------------
# meshes: the reference's dp×tp×sp steps on the conftest's CPU devices,
# the port's as gloo ranks (train_rank.py's mesh legs)
# --------------------------------------------------------------------------
MESH_ROWS = 4                    # the global batch of the mesh legs


def llama_cfg(**kw) -> dict:
    """A tiny llama configuration (RoPE, GQA with kv heads divisible by
    tp = 2, SwiGLU, RMSNorm, untied readout), as keywords of
    ``GPTConfig.llama`` on both sides."""
    return dict(vocab_size=256, max_seq=64, d_model=64, n_heads=4,
                n_kv_heads=2, n_layers=2, d_ff=128, **kw)


def llama_tree():
    return jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0),
                                           JConfig.llama(**llama_cfg())))


def j_mesh(axes: dict):
    total = int(np.prod(list(axes.values())))
    return make_mesh(MeshAxes(**axes), devices=jax.devices()[:total])


def ref_mesh_run(tree, tok, tgt, axes: dict, cfg=JCFG, steps: int = 3,
                 tx=None, resync: bool = False, **kw):
    """The reference's step on the mesh of ``axes`` (``optax.adamw(1e-3)``
    unless ``tx``) from ``tree`` on the global batch: (losses, flat
    params). ``resync``: after each step every device's replica of each
    leaf is set to device 0's (tp index 0's), the semantics the port keeps
    for the tp-replicated leaves under a lossy codec (the reference's
    replicas drift apart there)."""
    step, params, opt_state, bsh = j_train_step(
        cfg, j_mesh(axes), tx or optax.adamw(1e-3),
        init_params=jax.tree.map(jnp.array, tree), **kw)
    a, b = jax.device_put(tok, bsh), jax.device_put(tgt, bsh)
    losses = []
    for _ in range(steps):
        loss, params, opt_state = step(params, opt_state, a, b)
        losses.append(float(loss))
        if resync:
            params = jax.tree.map(
                lambda x: jax.device_put(np.asarray(x), x.sharding), params)
    return losses, np.concatenate([x.ravel() for x in ref_leaves(params)])


def ref_mesh_eval(tree, tok, tgt, etok, etgt, axes: dict, cfg=JCFG, **kw):
    ev, bsh = j_eval_step(cfg, j_mesh(axes), **kw)
    p = jax.tree.map(jnp.array, tree)
    loss = float(ev(p, jax.device_put(tok, bsh), jax.device_put(tgt, bsh)))
    ppl = j_perplexity(ev, p, list(zip(etok, etgt)), bsh)
    return loss, ppl


def port_mesh_run(io: Path, n: int, legs: list, arrays: dict) -> list:
    """Each of n gloo ranks' outputs of the port's mesh ``legs`` on
    ``arrays`` (``in.npz``)."""
    np.savez(io / "in.npz", **arrays)
    (io / "legs.json").write_text(json.dumps(legs))
    from test_torch_ring import run_group

    return run_group(io, n, (HELPERS / "train_rank.py").read_text())


def mesh_arrays(data, llama=None) -> dict:
    """``in.npz`` of the mesh legs: the tiny tree's leaves, the llama
    tree's as ``llama_p<i>``, the global batch and the eval batches."""
    tree, tok, tgt, etok, etgt = data
    out = {"tok": tok[:MESH_ROWS], "tgt": tgt[:MESH_ROWS],
           "etok": etok[:, :MESH_ROWS], "etgt": etgt[:, :MESH_ROWS]}
    for pre, t in (("", tree), ("llama_", llama)):
        if t is None:
            continue
        leaves = ref_leaves(t)
        out[f"{pre}n_leaves"] = len(leaves)
        out.update({f"{pre}p{i}": a for i, a in enumerate(leaves)})
    return out
