"""One rank of the pipeline and MoE parity tests
(``tests/test_torch_pipeline.py``, ``tests/test_torch_moe.py``).

``run_legs(io, rank, world)`` reads ``io/in.npz`` and ``io/legs.json`` (a
list of legs, each ``{"name", "kind", "mesh", ...}``, the mesh's product
the world size) and runs each leg on ``make_mesh`` of its mesh:

* ``"pipeline"``: ``pipeline_apply`` of ``tanh(x @ w + b)`` (with
  ``"aux": true`` also the block's ``mean(h²)`` as its aux) on this
  stage's rows of ``pipe_w``/``pipe_b`` and the microbatches ``pipe_x``;
  the per-stage loss (the last stage's ``mean(outs²)``, plus ``0.01 ·``
  the stage's aux) and its gradients: ``<leg>_outs``, ``_last`` (the
  outputs through ``last_stage_value``), ``_aux``, ``_loss``, ``_dw``,
  ``_db`` (this stage's rows), ``_dx``.
* ``"moe_ffn"``: ``moe_ffn`` at capacity factor 8 of this rank's ep rows
  of ``ffn_x`` with this rank's shards of the ``ffn_<mlp>_p<i>`` leaves
  (``moe_init``'s, in key order); loss ``mean(y²) + 0.01 · aux``:
  ``<leg>_y``, ``_aux``, ``_dx`` and ``_d<key>`` (this rank's shard).
* ``"pp_train"``, ``"moe_train"``, ``"moe_pp_train"``: the factory of
  that name from the whole tree ``<tree>_p<i>`` (the reference's leaves
  in ``jax.tree.flatten`` order) of the leg's config (``"cfg"``:
  keywords of ``GPTConfig``/``MoEGPTConfig`` over its ``tiny()``, or
  ``GPTConfig.llama``'s with ``"llama": true``; ``"opt": "sgd"`` with
  ``"lr"``: ``torch.optim.SGD``, else the port's ``adamw``), ``steps``
  steps on the global batch ``tok``/``tgt`` (``"zigzag"``: permuted): ``<leg>_loss``
  and ``<leg>_params``, the whole parameters in the reference's leaf
  order of the unstacked tree (the sharded leaves gathered, the others
  this rank's own copy), and ``<leg>_collectives`` (the counts by kind,
  in ``collectives``' key order).

Run as a script (``RANK WORLD STORE IO``), it joins a gloo group over a
FileStore, writes ``IO/out<RANK>.npz`` and prints ``{"ok": true}``: the
form ``tests/test_torch_ring.py``'s ``run_group`` starts. It imports
torch and the port only."""

import json
import sys

import numpy as np
import torch


def flat_tree(tree) -> list:
    """A nested numpy tree's leaves in ``jax.tree.leaves`` order (dict
    keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in flat_tree(tree[k])]
    if isinstance(tree, list):
        return [a for b in tree for a in flat_tree(b)]
    return [tree]


def _cfg(leg):
    from byteps_tpu_torch.models import GPTConfig, MoEGPTConfig

    kw = leg.get("cfg", {})
    if leg["kind"] in ("moe_train", "moe_pp_train"):
        return MoEGPTConfig(**{**MoEGPTConfig.tiny().__dict__, **kw})
    if leg.get("llama"):
        return GPTConfig.llama(**kw)
    return GPTConfig(**{**GPTConfig.tiny().__dict__, **kw})


def _pipeline(d, leg, mesh) -> dict:
    from byteps_tpu_torch.parallel.partitioner import block_of
    from byteps_tpu_torch.parallel.pipeline import (is_last_stage,
                                                    last_stage_value,
                                                    pipeline_apply)

    name, pp = leg["name"], mesh.axis("pp")
    rows = block_of(d["pipe_w"].shape[0], "pp", mesh)
    w = torch.from_numpy(d["pipe_w"][rows].copy()).requires_grad_()
    b = torch.from_numpy(d["pipe_b"][rows].copy()).requires_grad_()
    x = torch.from_numpy(d["pipe_x"].copy()).requires_grad_()
    aux_on = leg.get("aux", False)

    def blk(h, p):
        h = torch.tanh(h @ p["w"] + p["b"])
        return (h, (h ** 2).mean()) if aux_on else h

    res = pipeline_apply(x, {"w": w, "b": b}, blk, pp, has_aux=aux_on)
    outs, aux = res if aux_on else (res, torch.zeros(()))
    loss = (outs ** 2).mean() if is_last_stage(pp) else outs.sum()
    if aux_on:
        loss = loss + 0.01 * aux
    loss.backward()
    return {f"{name}_outs": outs.detach().numpy(),
            f"{name}_last": last_stage_value(outs, pp).numpy(),
            f"{name}_aux": np.array(float(aux)),
            f"{name}_loss": np.array(float(loss)),
            f"{name}_dw": w.grad.numpy(), f"{name}_db": b.grad.numpy(),
            f"{name}_dx": x.grad.numpy()}


def _moe_ffn(d, leg, mesh) -> dict:
    from byteps_tpu_torch.models.convert import shard_leaf
    from byteps_tpu_torch.parallel.moe import moe_ffn, moe_specs
    from byteps_tpu_torch.parallel.partitioner import block_of

    name, mlp = leg["name"], leg["mlp"]
    keys = sorted(["wg", "w1", "b1", "w2", "b2"]
                  + (["w3", "b3"] if mlp == "swiglu" else []))
    tp = "tp" if "tp" in mesh.axis_names else None
    specs = moe_specs("ep", tp, mlp=mlp)
    p = {k: torch.from_numpy(shard_leaf(d[f"ffn_{mlp}_p{i}"], specs[k],
                                        mesh).copy()).requires_grad_()
         for i, k in enumerate(keys)}
    rows = block_of(d["ffn_x"].shape[0], "ep", mesh)
    x = torch.from_numpy(d["ffn_x"][rows].copy()).requires_grad_()
    y, aux = moe_ffn(x, p, capacity_factor=8.0, ep_axis=mesh.axis("ep"),
                     tp_axis=mesh.axis(tp) if tp else None)
    ((y ** 2).mean() + 0.01 * aux).backward()
    out = {f"{name}_y": y.detach().numpy(),
           f"{name}_aux": np.array(float(aux)),
           f"{name}_dx": x.grad.numpy()}
    out.update({f"{name}_d{k}": t.grad.numpy() for k, t in p.items()})
    return out


def _train(d, leg, mesh) -> dict:
    from byteps_tpu_torch.models import (flat_leaves, gpt_init,
                                         make_gpt_moe_pp_train_step,
                                         make_gpt_moe_train_step,
                                         make_gpt_pp_train_step,
                                         moe_gpt_init, params_to_numpy)
    from byteps_tpu_torch.parallel.mesh import (collectives,
                                                reset_collectives)
    from byteps_tpu_torch.parallel.ring_attention import zigzag_permutation

    name, kind = leg["name"], leg["kind"]
    cfg = _cfg(leg)
    moe = kind != "pp_train"
    params = (moe_gpt_init if moe else gpt_init)(cfg, device="cpu")
    tree = leg["tree"]
    with torch.no_grad():
        for i, t in enumerate(flat_leaves(params)):
            t.copy_(torch.from_numpy(d[f"{tree}_p{i}"]))
    tok, tgt = d["tok"], d["tgt"]
    if leg.get("zigzag"):
        perm = zigzag_permutation(tok.shape[1], mesh.axis_size("sp"))
        tok, tgt = tok[:, perm.numpy()], tgt[:, perm.numpy()]
    factory = {"pp_train": make_gpt_pp_train_step,
               "moe_train": make_gpt_moe_train_step,
               "moe_pp_train": make_gpt_moe_pp_train_step}[kind]
    kw = dict(leg.get("kw", {}))
    if leg.get("opt") == "sgd":
        lr = leg["lr"]
        kw["make_optimizer"] = lambda leaves: torch.optim.SGD(leaves, lr=lr)
    step, p, _ = factory(cfg, mesh, init_params=params, device="cpu", **kw)
    reset_collectives()
    losses = [float(step(tok, tgt)) for _ in range(leg.get("steps", 3))]
    counts = np.array(list(collectives.values()))
    return {f"{name}_loss": np.array(losses),
            f"{name}_collectives": counts,
            f"{name}_params": np.concatenate(
                [a.ravel() for a in flat_tree(params_to_numpy(p,
                                                              mesh=mesh))])}


def run_legs(io: str, rank: int, world: int) -> dict:
    from byteps_tpu_torch.parallel.mesh import MeshAxes, make_mesh

    d = np.load(f"{io}/in.npz")
    with open(f"{io}/legs.json") as f:
        legs = json.load(f)
    out = {}
    for leg in legs:
        mesh = make_mesh(MeshAxes(**leg["mesh"]))
        kind = leg["kind"]
        fn = (_pipeline if kind == "pipeline" else
              _moe_ffn if kind == "moe_ffn" else _train)
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
