"""One rank of the port's training-option parity tests
(``tests/test_torch_zero.py``, ``tests/test_torch_accum_eval.py``).

``run_legs(io, rank, world)`` reads ``io/in.npz`` (the reference's
initial leaves in ``jax.tree.flatten`` order as ``p0``, ``p1``, …; the
global batch ``tok``/``tgt``, this rank's rows ``[rank·B, (rank+1)·B)``;
the eval batches ``etok``/``etgt``) and ``io/legs.json`` (a list of
``{"name", "kw", "env", "steps", "eval"}``), and for each leg builds the
port's ``make_gpt_train_step(**kw)`` from those weights under the leg's
environment and trains ``steps`` steps on the rank's batch, or (an eval
leg) runs ``make_eval_step`` and ``evaluate_perplexity``. Returns the
arrays to compare: ``<leg>_loss``, ``<leg>_params`` (flat, in leaf
order), ``<leg>_moments`` (the numel of each per-element optimizer state
tensor), ``<leg>_moment_bytes``, ``<leg>_ef``; ``<leg>_ppl`` for an eval
leg.

A leg with a ``mesh`` field (``MeshAxes`` keywords; its product the
world size) runs on ``make_mesh`` of it: the step and the eval step take
the global batch (``zigzag``: permuted by ``zigzag_permutation``), and
the leg's ``tree`` (``"tiny"``, the leaves ``p0``, …; another name, the
leaves ``<tree>_p0``, … of ``GPTConfig.llama(**leg["cfg"])``) is the
whole model each rank shards. It adds ``<leg>_rep`` (this rank's
tp-replicated leaves, flat, to compare across ranks), ``<leg>_coords``
(its (dp, tp, sp) indices) and, with ``"moments": true``, ``<leg>_m1``
(AdamW's first moments gathered whole over tp, flat). ``<leg>_params``
is then the parameters gathered whole (``params_to_numpy(mesh=)``). A
``"kind": "ce"`` leg runs ``chunked_ce_nll`` with the vocab split over
tp on ``ce_h``/``ce_head<V>``/``ce_tgt<V>`` for each V of ``vocabs``
and reports each NLL and the gradients of its mean.

Run as a script (``RANK WORLD STORE IO``), it joins a gloo group over a
FileStore, writes ``IO/out<RANK>.npz`` and prints ``{"ok": true}``: the
form ``tests/test_torch_ring.py``'s ``run_group`` starts. It imports
torch and the port only."""

import json
import os
import sys

import numpy as np
import torch


def run_legs(io: str, rank: int, world: int) -> dict:
    from byteps_tpu_torch.common.config import reset_config
    from byteps_tpu_torch.models import (GPTConfig, evaluate_perplexity,
                                         flat_leaves, gpt_init,
                                         make_eval_step, make_gpt_train_step)

    d = np.load(f"{io}/in.npz")
    with open(f"{io}/legs.json") as f:
        legs = json.load(f)
    mesh_legs = [g for g in legs if "mesh" in g]
    if mesh_legs:
        out = {}
        for leg in mesh_legs:
            out.update(_mesh_leg(d, leg))
        return out
    cfg = GPTConfig.tiny()
    B = d["tok"].shape[0] // world
    rows = slice(rank * B, (rank + 1) * B)
    tok, tgt = d["tok"][rows], d["tgt"][rows]
    batches = [(t[rows], g[rows]) for t, g in zip(d["etok"], d["etgt"])]
    leaves = [d[f"p{i}"] for i in range(int(d["n_leaves"]))]

    def params():
        p = gpt_init(cfg, device="cpu")
        with torch.no_grad():
            for t, a in zip(flat_leaves(p), leaves):
                t.copy_(torch.from_numpy(a))
        return p

    out = {}
    for leg in legs:
        name, env = leg["name"], leg.get("env", {})
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        reset_config()
        try:
            if leg.get("eval"):
                ev = make_eval_step(cfg, device="cpu")
                p = params()
                out[f"{name}_loss"] = np.array([float(ev(p, tok, tgt))])
                out[f"{name}_ppl"] = np.array(
                    [evaluate_perplexity(ev, p, batches)])
                continue
            step, p, opt = make_gpt_train_step(cfg, init_params=params(),
                                               device="cpu", **leg["kw"])
            out[f"{name}_loss"] = np.array(
                [float(step(tok, tgt)) for _ in range(leg.get("steps", 3))])
            out[f"{name}_params"] = np.concatenate(
                [t.detach().numpy().ravel() for t in flat_leaves(p)])
            out[f"{name}_moments"] = np.array(
                [t.numel() for st in opt.optimizer.state.values()
                 for t in st.values() if torch.is_tensor(t) and t.ndim > 0])
            out[f"{name}_moment_bytes"] = np.array(opt.moment_bytes())
            if opt.ef is not None:
                out[f"{name}_ef"] = opt.ef.numpy().copy()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            reset_config()
    return out


def _mesh_leg(d, leg: dict) -> dict:
    """One leg on a mesh (the module docstring)."""
    from byteps_tpu_torch.models import (GPTConfig, evaluate_perplexity,
                                         flat_leaves, gpt_init,
                                         make_eval_step, make_gpt_train_step,
                                         params_to_numpy)
    from byteps_tpu_torch.models.convert import (flat_specs, gather_leaf,
                                                 param_specs)
    from byteps_tpu_torch.parallel.mesh import MeshAxes, make_mesh
    from byteps_tpu_torch.parallel.partitioner import spec_axes
    from byteps_tpu_torch.parallel.ring_attention import zigzag_permutation
    from byteps_tpu_torch.parallel.sharding import opt_state_specs

    name, kind = leg["name"], leg.get("kind", "train")
    axes = MeshAxes(**leg["mesh"])
    mesh = make_mesh(axes)
    coords = [mesh.axis_index(a) if a in mesh.axis_names else 0
              for a in ("dp", "tp", "sp")]
    out = {f"{name}_coords": np.array(coords)}
    if kind == "ce":
        from byteps_tpu_torch.ops.chunked_ce import chunked_ce_nll
        tp = mesh.axis("tp")
        for V in leg["vocabs"]:
            h = torch.from_numpy(d["ce_h"].copy()).requires_grad_()
            head = torch.from_numpy(d[f"ce_head{V}"].copy()).requires_grad_()
            tgt = torch.from_numpy(d[f"ce_tgt{V}"].copy())
            nll = chunked_ce_nll(h, head, tgt, row_block=8, tp_axis=tp)
            nll.mean().backward()
            out[f"{name}_{V}_nll"] = nll.detach().numpy()
            out[f"{name}_{V}_dh"] = h.grad.numpy()
            out[f"{name}_{V}_dhead"] = head.grad.numpy()
        return out
    tree = leg.get("tree", "tiny")
    pre = "" if tree == "tiny" else f"{tree}_"
    cfg = (GPTConfig.tiny() if tree == "tiny"
           else GPTConfig.llama(**leg["cfg"]))
    leaves = [d[f"{pre}p{i}"] for i in range(int(d[f"{pre}n_leaves"]))]
    params = gpt_init(cfg, device="cpu")
    with torch.no_grad():
        for t, a in zip(flat_leaves(params), leaves):
            t.copy_(torch.from_numpy(a))
    tok, tgt = d["tok"], d["tgt"]
    if leg.get("zigzag"):
        perm = zigzag_permutation(tok.shape[1], axes.sp).numpy()
        tok, tgt = tok[:, perm], tgt[:, perm]
    if kind == "eval":
        kw = leg.get("kw", {})
        ev = make_eval_step(cfg, device="cpu", mesh=mesh, **kw)
        from byteps_tpu_torch.models.convert import shard_params
        p = shard_params(params, mesh)
        out[f"{name}_loss"] = np.array([float(ev(p, tok, tgt))])
        out[f"{name}_ppl"] = np.array([evaluate_perplexity(
            ev, p, list(zip(d["etok"], d["etgt"])))])
        return out
    step, p, opt = make_gpt_train_step(cfg, init_params=params,
                                       device="cpu", mesh=mesh,
                                       **leg.get("kw", {}))
    out[f"{name}_loss"] = np.array(
        [float(step(tok, tgt)) for _ in range(leg.get("steps", 3))])
    tree_np = params_to_numpy(p, mesh=mesh)
    out[f"{name}_params"] = np.concatenate(
        [a.ravel() for a in _flat_tree(tree_np)])
    specs = flat_specs(param_specs(cfg, mesh))
    mine = flat_leaves(p)
    out[f"{name}_rep"] = np.concatenate(
        [t.detach().numpy().ravel() for t, s in zip(mine, specs)
         if "tp" not in spec_axes(s)])
    if leg.get("moments"):
        st = [opt.optimizer.state[t] for t in mine]
        ss = opt_state_specs(st, mine, specs)
        out[f"{name}_m1"] = np.concatenate(
            [gather_leaf(s["exp_avg"], sp["exp_avg"], mesh).numpy().ravel()
             for s, sp in zip(st, ss)])
    return out


def _flat_tree(tree: dict) -> list:
    """A numpy parameter tree's leaves in ``jax.tree.leaves`` order."""
    out = []
    for k in sorted(tree):
        if k == "blocks":
            for b in tree["blocks"]:
                out.extend(b[j] for j in sorted(b))
        else:
            out.append(tree[k])
    return out


if __name__ == "__main__":
    import torch.distributed as dist

    rank, world, store, io = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    np.savez(f"{io}/out{rank}.npz", **run_legs(io, rank, world))
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps({"rank": rank, "ok": True}))
