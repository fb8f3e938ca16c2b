"""One rank of the multi-slice, ZeRO-3 and ZeRO-1-over-a-subgroup parity
tests (``tests/test_torch_multislice.py``, ``tests/test_torch_zero3.py``).

``run_legs(io, rank, world)`` reads ``io/in.npz`` and ``io/legs.json`` (a
list of legs, each ``{"name", "kind", "mesh", ...}``, the mesh's product
the world size) and runs each leg on ``make_mesh`` of its mesh:

* ``"hier_opt"``: ``DistributedOptimizer`` alone around
  ``torch.optim.SGD(lr=1)`` on one zero (L,) parameter, over the mesh's
  dp axis with its ``slice_`` axis as ``dcn_axis`` (``"comp"`` the
  codec, ``"pb"`` the partition bytes), ``steps`` steps, step s taking
  row ``hier_rows_<L>[s, rank]`` as the gradient (``"draws"``: randomk
  takes the indices ``draw_<i>`` for the key ``draw_keys[i]``, the
  reference's draws): ``<leg>_w`` (the
  parameter after each step), ``<leg>_ef`` (the EF residual after each
  step) and ``<leg>_collectives``.
* ``"train"``, ``"pp_train"``, ``"moe_train"``: ``make_gpt_train_step``,
  ``make_gpt_pp_train_step`` or ``make_gpt_moe_train_step`` from the
  whole tree ``<tree>_p<i>`` (the reference's leaves in
  ``jax.tree.flatten`` order) of ``GPTConfig.tiny()`` or
  ``MoEGPTConfig.tiny()`` with the leg's ``"cfg"`` keywords over it,
  ``"kw"`` to the factory (``"opt": "sgd"`` with ``"lr"``:
  ``torch.optim.SGD``, else the port's ``adamw``), ``steps`` steps on the
  global batch ``<batch>tok``/``<batch>tgt`` (``"batch"``, default no
  prefix): ``<leg>_loss``, ``<leg>_params`` (the whole parameters in the
  reference's unstacked leaf order), ``<leg>_local`` (this rank's own
  leaves, flat), ``<leg>_rep`` (those of them no tp axis splits),
  ``<leg>_collectives`` (in ``collectives``' key order)
  and ``<leg>_ef_len``.
* ``"eval"``: ``make_eval_step`` on this rank's shards of the tree:
  ``<leg>_loss`` of the first batch and ``<leg>_ppl`` over ``etok``/
  ``etgt``.
* ``"zero3"``: ``make_gpt_train_step(zero_3=True, **kw)`` from the tree:
  ``<leg>_loss``, ``<leg>_rest`` and ``<leg>_b<i>`` (each group's whole
  segments after the steps, ``zero3_segments_to_numpy``),
  ``<leg>_params`` (``zero3_gather_params`` of them, flat in leaf
  order), ``<leg>_init_rest``/``<leg>_init_b<i>`` (this rank's segments
  before the first step), ``<leg>_bytes`` (``state_bytes``) and
  ``<leg>_collectives``.

Run as a script (``RANK WORLD STORE IO``), it joins a gloo group over a
FileStore, writes ``IO/out<RANK>.npz`` and prints ``{"ok": true}``: the
form ``tests/test_torch_ring.py``'s ``run_group`` starts. It imports
torch and the port only."""

import json
import sys

import numpy as np
import torch


def flat_tree(tree) -> list:
    """A nested numpy tree's leaves in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in flat_tree(tree[k])]
    if isinstance(tree, list):
        return [a for b in tree for a in flat_tree(b)]
    return [tree]


def _counts() -> np.ndarray:
    from byteps_tpu_torch.parallel.mesh import collectives

    return np.array(list(collectives.values()))


def _hier_opt(d, leg, mesh) -> dict:
    from byteps_tpu_torch.optimizer import DistributedOptimizer
    from byteps_tpu_torch.parallel.mesh import reset_collectives

    name, L = leg["name"], leg["L"]
    rows = d[f"hier_rows_{L}"]
    if leg.get("draws"):
        # randomk from the reference's draws: its indices for every key
        # the step derives, under the port's key of the same derivation
        from byteps_tpu_torch.compression.randomk import RandomkCompressor

        table = {int(k): d[f"draw_{i}"] for i, k in enumerate(d["draw_keys"])}
        RandomkCompressor._indices = staticmethod(
            lambda key, n, k, device: torch.from_numpy(table[key].copy()))
    w = torch.zeros(L)
    opt = DistributedOptimizer(
        torch.optim.SGD([w], lr=1.0), [w], leg.get("comp"),
        partition_bytes=leg.get("pb"), axis=mesh.axis("dp"),
        dcn_axis=mesh.axis("slice_"), joint_axis=mesh.axes(("slice_", "dp")))
    reset_collectives()
    ws, efs = [], []
    for s in range(leg["steps"]):
        w.grad = torch.from_numpy(rows[s, mesh.rank].copy())
        opt.step()
        ws.append(w.detach().numpy().copy())
        if opt.ef is not None:
            efs.append(opt.ef.numpy().copy())
    out = {f"{name}_w": np.stack(ws), f"{name}_collectives": _counts()}
    if efs:
        out[f"{name}_ef"] = np.stack(efs)
    return out


def _cfg(leg):
    from byteps_tpu_torch.models import GPTConfig, MoEGPTConfig

    base = MoEGPTConfig if leg["kind"] == "moe_train" else GPTConfig
    return base(**{**base.tiny().__dict__, **leg.get("cfg", {})})


def _init(d, leg, cfg):
    from byteps_tpu_torch.models import flat_leaves, gpt_init, moe_gpt_init

    init = moe_gpt_init if leg["kind"] == "moe_train" else gpt_init
    params = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        for i, t in enumerate(flat_leaves(params)):
            t.copy_(torch.from_numpy(d[f"{leg['tree']}_p{i}"]))
    return params


def _kw(leg) -> dict:
    kw = dict(leg.get("kw", {}))
    if leg.get("opt") == "sgd":
        lr = leg["lr"]
        kw["make_optimizer"] = lambda leaves: torch.optim.SGD(leaves, lr=lr)
    return kw


def _train(d, leg, mesh) -> dict:
    from byteps_tpu_torch.models import (flat_leaves, make_eval_step,
                                         make_gpt_moe_train_step,
                                         make_gpt_pp_train_step,
                                         make_gpt_train_step,
                                         params_to_numpy)
    from byteps_tpu_torch.models.convert import (flat_specs, param_specs,
                                                 shard_params)
    from byteps_tpu_torch.models.train import evaluate_perplexity
    from byteps_tpu_torch.parallel.mesh import reset_collectives
    from byteps_tpu_torch.parallel.partitioner import spec_axes

    name, kind = leg["name"], leg["kind"]
    cfg = _cfg(leg)
    params = _init(d, leg, cfg)
    pre = leg.get("batch", "")
    tok, tgt = d[f"{pre}tok"], d[f"{pre}tgt"]
    if kind == "eval":
        ev = make_eval_step(cfg, device="cpu", mesh=mesh)
        p = shard_params(params, mesh)
        return {f"{name}_loss": np.array([float(ev(p, tok, tgt))]),
                f"{name}_ppl": np.array([evaluate_perplexity(
                    ev, p, list(zip(d["etok"], d["etgt"])))])}
    if kind == "train":
        step, p, opt = make_gpt_train_step(cfg, init_params=params,
                                           device="cpu", mesh=mesh,
                                           **_kw(leg))
    else:
        factory = (make_gpt_pp_train_step if kind == "pp_train"
                   else make_gpt_moe_train_step)
        step, p, opt = factory(cfg, mesh, init_params=params, device="cpu",
                               **_kw(leg))
    reset_collectives()
    losses = [float(step(tok, tgt)) for _ in range(leg.get("steps", 3))]
    specs = flat_specs(param_specs(cfg, mesh, p.stacked))
    return {f"{name}_loss": np.array(losses),
            f"{name}_rep": np.concatenate(
                [t.detach().numpy().ravel()
                 for t, sp in zip(flat_leaves(p), specs)
                 if "tp" not in spec_axes(sp)]),
            f"{name}_collectives": _counts(),
            f"{name}_ef_len": np.array(-1 if opt.ef is None
                                       else opt.ef.numel()),
            f"{name}_local": np.concatenate(
                [t.detach().numpy().ravel() for t in flat_leaves(p)]),
            f"{name}_params": np.concatenate(
                [a.ravel() for a in flat_tree(params_to_numpy(p,
                                                              mesh=mesh))])}


def _zero3(d, leg, mesh) -> dict:
    from byteps_tpu_torch.models import flat_leaves, make_gpt_train_step
    from byteps_tpu_torch.models.convert import zero3_segments_to_numpy
    from byteps_tpu_torch.parallel.mesh import reset_collectives
    from byteps_tpu_torch.parallel.zero3 import (state_bytes,
                                                 zero3_gather_params)

    name = leg["name"]
    cfg = _cfg(leg)
    step, segs, opt = make_gpt_train_step(
        cfg, init_params=_init(d, leg, cfg), device="cpu", mesh=mesh,
        zero_3=True, **_kw(leg))
    out = {f"{name}_init_rest": segs["rest"].detach().numpy().copy()}
    out.update({f"{name}_init_b{i}": b.detach().numpy().copy()
                for i, b in enumerate(segs["blocks"])})
    reset_collectives()
    out[f"{name}_loss"] = np.array(
        [float(step(d["tok"], d["tgt"])) for _ in range(leg["steps"])])
    out[f"{name}_collectives"] = _counts()
    out[f"{name}_bytes"] = np.array(state_bytes(segs, opt))
    whole = zero3_segments_to_numpy(segs, mesh)
    out[f"{name}_rest"] = whole["rest"]
    out.update({f"{name}_b{i}": b for i, b in enumerate(whole["blocks"])})
    out[f"{name}_params"] = np.concatenate(
        [t.numpy().ravel() for t in flat_leaves(zero3_gather_params(whole,
                                                                    cfg))])
    return out


def run_legs(io: str, rank: int, world: int) -> dict:
    from byteps_tpu_torch.parallel.mesh import MeshAxes, make_mesh

    d = np.load(f"{io}/in.npz")
    with open(f"{io}/legs.json") as f:
        legs = json.load(f)
    out = {}
    for leg in legs:
        mesh = make_mesh(MeshAxes(**leg["mesh"]))
        fn = {"hier_opt": _hier_opt, "zero3": _zero3}.get(leg["kind"],
                                                          _train)
        out.update(fn(d, leg, mesh))
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
