"""Shared plumbing of the pipeline and MoE parity tests
(``tests/test_torch_pipeline.py``, ``tests/test_torch_moe.py``): the
port's rank groups (``tests/helpers/pp_moe_rank.py``, each group run once
a test session under a file lock), and the reference's steps on the
conftest's CPU devices, read back per device.

A leaf that the reference's mesh replicates may hold different values on
different devices (a lossy codec's chunk scale spans a device's own
shards and the replicated leaves, so each device's aggregate of those
leaves differs; the port's ranks keep theirs apart the same way):
:func:`device_view` reads device r's own copy of such a leaf, and the
whole array of a sharded one, which is what the port's rank r reports."""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax

from byteps_tpu.parallel import MeshAxes, make_mesh

HELPERS = Path(__file__).resolve().parent
sys.path.insert(0, str(HELPERS))
from train_parity import ONEBIT_OFF_SHARE, off_share  # noqa: E402

B, S = 8, 32                     # the global batch of the train legs


def batch(seed: int = 11):
    toks = np.random.default_rng(seed).integers(0, 256, (B, S + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def j_mesh(axes: dict):
    a = MeshAxes(**axes)
    return make_mesh(a, devices=jax.devices()[:a.total])


def tree_leaves(tree) -> list:
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@contextlib.contextmanager
def _locked(path: Path):
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def port_groups(tag: str, legs_by_n: dict, arrays: dict,
                tmp_path_factory, script: str = "pp_moe_rank.py") -> dict:
    """{n: [each rank's outputs]} of ``legs_by_n[n]`` on n gloo ranks
    running ``script`` (a rank script of this directory), computed once a
    test session across xdist workers (the first worker to need a group
    runs it under a file lock and leaves its outputs)."""
    from test_torch_ring import run_group

    base = tmp_path_factory.getbasetemp()
    shared = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    res = {}
    for n, legs in legs_by_n.items():
        done = shared / f"{tag}_{n}"
        with _locked(shared / f"{tag}_{n}.lock"):
            if not (done / "ok").exists():
                done.mkdir(exist_ok=True)
                np.savez(done / "in.npz", **arrays)
                (done / "legs.json").write_text(json.dumps(legs))
                outs = run_group(done, n, (HELPERS / script).read_text())
                for r, o in enumerate(outs):
                    np.savez(done / f"res{r}.npz", **o)
                (done / "ok").write_text("")
        res[n] = [dict(np.load(done / f"res{r}.npz")) for r in range(n)]
    return res


def leg_ranks(groups: dict, legs_by_n: dict, leg: str) -> list:
    n = next(k for k, legs in legs_by_n.items()
             if any(g["name"] == leg for g in legs))
    return groups[n]


def device_view(x, r: int) -> np.ndarray:
    """Device r's copy of a fully replicated array, else the whole
    array."""
    if x.sharding.is_fully_replicated:
        return np.asarray(next(s.data for s in x.addressable_shards
                               if s.device.id == r))
    return np.asarray(x)


def unstack(params) -> dict:
    """A stacked reference tree (``params["blocks"]`` one slab) → the
    unstacked one (``"blocks"`` a list of per-layer trees)."""
    out = {k: v for k, v in params.items() if k != "blocks"}
    n = jax.tree.leaves(params["blocks"])[0].shape[0]
    out["blocks"] = [jax.tree.map(lambda a: a[i], params["blocks"])
                     for i in range(n)]
    return out


SGD_LR = 0.5


def ref_train(factory, cfg, axes: dict, tok, tgt, steps: int = 3,
              stacked: bool = False, opt: str = "adamw", **kw):
    """The reference's ``factory`` (``optax.adamw(1e-3)``, or with
    ``opt="sgd"`` ``optax.sgd(SGD_LR)``) on the mesh of ``axes``:
    (losses, [device r's view of the whole parameters, flat in the
    unstacked tree's leaf order, for each device r])."""
    mesh = j_mesh(axes)
    tx = optax.sgd(SGD_LR) if opt == "sgd" else optax.adamw(1e-3)
    step, params, opt_state, bsh = factory(cfg, mesh, tx, **kw)
    a, b = jax.device_put(tok, bsh), jax.device_put(tgt, bsh)
    losses = []
    for _ in range(steps):
        loss, params, opt_state = step(params, opt_state, a, b)
        losses.append(float(loss))
    views = []
    for r in range(mesh.devices.size):
        tree = jax.tree.map(lambda x: device_view(x, r), params)
        if stacked:
            tree = unstack(tree)
        views.append(np.concatenate(
            [np.asarray(x).ravel() for x in jax.tree.leaves(tree)]))
    return losses, views


def jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def leaf_names(tree) -> np.ndarray:
    """Each element's leaf name, in the unstacked tree's flat order."""
    out = []

    def walk(t, pre):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{pre}.{k}")
        elif isinstance(t, list):
            for i, b in enumerate(t):
                walk(b, f"{pre}.{i}")
        else:
            out.extend([pre] * t.size)

    walk(tree, "")
    return np.array(out)


def assert_onebit_held(got, want, names, steps=3, lr=1e-3):
    """PR 19's onebit bound (a share under 1e-3 of the parameters further
    than 1e-5) on every leaf but the key bias; the key bias within its
    sign noise, 2·lr a step. Its exact gradient is zero (it shifts every
    score of a query alike, which the softmax cancels), so onebit sends
    each element ±scale by the sign roundoff gives it, in either
    package."""
    bk = np.char.endswith(names, ".bk")
    assert off_share(got[~bk], want[~bk]) < ONEBIT_OFF_SHARE
    assert np.abs(got[bk] - want[bk]).max() <= 2 * lr * steps


def fake_mesh(axes: dict, rank: int):
    """The port's Mesh of ``axes`` as rank ``rank`` sees it, without
    process groups (what a factory checks before any collective)."""
    from byteps_tpu_torch.parallel.mesh import (Axis, Mesh, MeshAxes,
                                                layout, rank_coords)

    ma = MeshAxes(**axes)
    names, sizes = layout(ma)
    coords = rank_coords(ma, rank)
    return Mesh({nm: Axis(nm, s, coords[nm], ()) for nm, s in
                 zip(names, sizes)}, rank)


__all__ = ["B", "S", "SGD_LR", "assert_onebit_held", "batch",
           "device_view", "fake_mesh", "j_mesh", "jnp_tree", "leaf_names",
           "leg_ranks", "port_groups", "ref_train",
           "tree_leaves", "unstack"]
