"""One rank of the ring-subgroup, sharded-decode and sharded-serve parity
tests (``tests/test_torch_ring_subgroup.py``,
``tests/test_torch_generate_parallel.py``,
``tests/test_torch_serve_parallel.py``).

``run_legs(io, rank, world)`` reads ``io/in.npz`` and ``io/legs.json`` (a
list of legs, each ``{"name", "kind", "mesh", ...}``, the mesh's product
the world size) and runs each leg on ``make_mesh`` of its mesh:

* ``"ring_ops"``: over this rank's dp line (its group), ``ring_collect``,
  ``ring_allgather`` and ``ring_presum`` of this rank's rows
  ``<leg>_<dtype>_rows`` (``(world, n_dp, ...)``, row ``rank``) and the
  staged bodies' exchange and gather of the same (``comm/ici.py``):
  ``<leg>_<dtype>_{collect,gather,presum}`` and ``..._staged_{collect,
  gather}``.
* ``"hier_opt"``, ``"train"``: ``multislice_rank``'s legs, and
  ``"dp_opt"``: ``DistributedOptimizer`` alone over the mesh's dp axis
  (SGD at lr 1 on one zero (L,) parameter, step s taking row
  ``dp_rows[s, rank]``: ``<leg>_w``, ``<leg>_ef`` after each step), each
  with ``BYTEPS_ICI_TIER`` set to the leg's ``"tier"`` around it.
* ``"generate"``: ``make_generate_fn`` over the mesh's tp and ep axes on
  this rank's shards of the whole tree ``<tree>_p<i>`` (the reference's
  leaves in ``jax.tree.flatten`` order; ``"moe"``: the MoE GPT),
  ``"max_new"`` greedy tokens from the prompt ``<leg>_prompt``:
  ``<leg>_tokens`` and the prefill's logits ``<leg>_logits``; with
  ``"lora"`` the adapter tree ``lora_<i>_<t>_{a,b}`` is cut by
  ``lora_param_specs`` (``adapters_from_numpy(mesh=)``) and
  grafted at ``"scale"``, and the
  leg also gives ``gpt_forward``'s logits ``<leg>_fwd``, the adapters
  gathered back ``<leg>_adapters`` (flat); with ``"quant"`` the cache is
  int8.
* ``"seg_rowpar"``: ``segmented_lora_delta(row_parallel=True)`` on this
  rank's share of ``d_in`` of ``seg_x``/``seg_a`` with ``seg_b`` and
  ``seg_slots``: ``<leg>_delta`` and the tp sums it issued.
* ``"paged"``: the paged prefill and decode steps over the mesh's tp
  axis, a fixed schedule (two prompts, then ``"steps"`` packed decode
  steps of fixed tokens): ``<leg>_logits`` (every step's logits, in
  order, flat).
* ``"sched"``: ``Scheduler(tp_axis=)`` serving ``"n"`` requests
  ``sched_prompt_<i>`` (``"max_new"`` each): ``<leg>_tokens`` (each
  request's tokens, concatenated) and ``<leg>_clock`` (the shared clock
  read after the drain on every rank).

Run as a script (``RANK WORLD STORE IO``), it joins a gloo group over a
FileStore, writes ``IO/out<RANK>.npz`` and prints ``{"ok": true}``: the
form ``tests/test_torch_ring.py``'s ``run_group`` starts. It imports
torch and the port only."""

import contextlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.getcwd(), "tests", "helpers"))
import multislice_rank  # noqa: E402

PAGED_BS = 8


@contextlib.contextmanager
def _tier(tier):
    from byteps_tpu_torch.common.config import reset_config

    old = os.environ.get("BYTEPS_ICI_TIER")
    if tier is not None:
        os.environ["BYTEPS_ICI_TIER"] = tier
    reset_config()
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("BYTEPS_ICI_TIER", None)
        else:
            os.environ["BYTEPS_ICI_TIER"] = old
        reset_config()


def _ring_ops(d, leg, mesh) -> dict:
    from byteps_tpu_torch.comm import ici
    from byteps_tpu_torch.ops.ring_collective_kernels import (
        close_workspaces, ring_allgather, ring_collect, ring_presum)

    dp = mesh.axis("dp")
    out = {}
    for dt in leg["dtypes"]:
        key = f"{leg['name']}_{dt}"
        x = torch.from_numpy(d[f"{key}_rows"][mesh.rank].copy())
        out[f"{key}_collect"] = ring_collect(x, group=dp.group).numpy()
        out[f"{key}_gather"] = ring_allgather(x[0], group=dp.group).numpy()
        out[f"{key}_staged_collect"] = ici._exchange(
            {"x": x}, dp.size, "staged", dp.group)["x"].numpy()
        out[f"{key}_staged_gather"] = ici._gather(
            {"x": x[0]}, dp.size, "staged", dp.group)["x"].numpy()
        if x.dtype == torch.float32:
            out[f"{key}_presum"] = ring_presum(x, group=dp.group).numpy()
    close_workspaces(dp.group)
    return out


def _dp_opt(d, leg, mesh) -> dict:
    from byteps_tpu_torch.optimizer import DistributedOptimizer

    name, L = leg["name"], leg["L"]
    w = torch.zeros(L)
    opt = DistributedOptimizer(torch.optim.SGD([w], lr=1.0), [w],
                               leg["comp"], partition_bytes=leg["pb"],
                               axis=mesh.axis("dp"))
    ws, efs = [], []
    for s in range(leg["steps"]):
        w.grad = torch.from_numpy(d["dp_rows"][s, mesh.rank].copy())
        opt.step()
        ws.append(w.detach().numpy().copy())
        efs.append(opt.ef.numpy().copy())
    return {f"{name}_w": np.stack(ws), f"{name}_ef": np.stack(efs)}


def _model(d, leg):
    from byteps_tpu_torch.models import (GPTConfig, MoEGPTConfig,
                                         flat_leaves, gpt_init, moe_gpt_init)

    base = MoEGPTConfig if leg.get("moe") else GPTConfig
    cfg = base(**{**base.tiny().__dict__, **leg.get("cfg", {})})
    init = moe_gpt_init if leg.get("moe") else gpt_init
    params = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        for i, t in enumerate(flat_leaves(params)):
            t.copy_(torch.from_numpy(d[f"{leg['tree']}_p{i}"]))
    return cfg, params


def _axis(mesh, name):
    return mesh.axis(name) if name in mesh.axis_names else None


def _adapter_tree(d, cfg, targets) -> dict:
    return {"blocks": [{t: {"a": d[f"lora_{i}_{t}_a"],
                            "b": d[f"lora_{i}_{t}_b"]} for t in targets}
                       for i in range(cfg.n_layers)]}


def _generate(d, leg, mesh) -> dict:
    from byteps_tpu_torch.models import gpt_forward, make_generate_fn
    from byteps_tpu_torch.models.convert import (adapters_from_numpy,
                                                 adapters_to_numpy,
                                                 shard_params)
    from byteps_tpu_torch.models.generate import gpt_apply_cached, init_cache
    from byteps_tpu_torch.models.lora import graft_lora

    name = leg["name"]
    cfg, whole = _model(d, leg)
    params = shard_params(whole, mesh)
    tp, ep = _axis(mesh, "tp"), _axis(mesh, "ep")
    out = {}
    if leg.get("lora"):
        targets = leg["targets"]
        ad = adapters_from_numpy(_adapter_tree(d, cfg, targets),
                                 device="cpu", mesh=mesh)
        back = adapters_to_numpy(ad, mesh=mesh)
        out[f"{name}_adapters"] = np.concatenate(
            [back["blocks"][i][t][k].ravel() for i in range(cfg.n_layers)
             for t in targets for k in ("a", "b")])
        params = graft_lora(params, ad, leg["scale"])
        with torch.no_grad():
            out[f"{name}_fwd"] = gpt_forward(
                params, torch.from_numpy(d[f"{name}_prompt"]), cfg,
                tp_axis=tp).numpy()
    prompt = torch.from_numpy(d[f"{name}_prompt"])
    cache = init_cache(cfg, prompt.shape[0],
                       h_loc=params["blocks"][0]["wk"].shape[-1]
                       // cfg.head_dim, quant=leg.get("quant", False),
                       device="cpu")
    logits, _ = gpt_apply_cached(params, prompt, cache, cfg, tp, ep)
    out[f"{name}_logits"] = logits.numpy()
    gen = make_generate_fn(cfg, leg["max_new"], tp_axis=tp, ep_axis=ep,
                           quant_cache=leg.get("quant", False),
                           device="cpu")
    out[f"{name}_tokens"] = gen(params, prompt).numpy()
    return out


def _seg_rowpar(d, leg, mesh) -> dict:
    from byteps_tpu_torch.ops.segmented_lora import segmented_lora_delta
    from byteps_tpu_torch.parallel.mesh import collectives, reset_collectives

    tp = mesh.axis("tp")
    x, a = d["seg_x"], d["seg_a"]
    w = x.shape[-1] // tp.size
    lo = tp.index * w
    reset_collectives()
    delta = segmented_lora_delta(
        torch.from_numpy(x[..., lo:lo + w].copy()),
        torch.from_numpy(a[:, lo:lo + w].copy()),
        torch.from_numpy(d["seg_b"]), torch.from_numpy(d["seg_slots"]),
        row_parallel=True, tp_axis=tp)
    return {f"{leg['name']}_delta": delta.numpy(),
            f"{leg['name']}_sums": np.array(collectives["tp_allreduce_fwd"])}


def paged_schedule(cfg, params, tp_axis, pool_blocks: int, steps: int,
                   d) -> list:
    """The fixed paged schedule of the ``"paged"`` leg (also run on one
    rank by the test): prompts ``paged_p0`` and ``paged_p1`` prefilled
    into tables ``[1, 2]`` and ``[3, 4]`` (the second in two chunks),
    then ``steps`` packed decode steps of both rows feeding
    ``paged_toks[s]`` at their next positions. Returns every call's
    logits, in order."""
    from byteps_tpu_torch.serve.paged_cache import (PagedKVCache,
                                                    make_paged_decode_fn,
                                                    make_paged_prefill_fn)

    h_loc = params["blocks"][0]["wk"].shape[-1] // cfg.head_dim
    cache = PagedKVCache(cfg, block_size=PAGED_BS, pool_blocks=pool_blocks,
                         max_batch=2, h_loc=h_loc, device="cpu")
    pre = make_paged_prefill_fn(cfg, PAGED_BS, tp_axis)
    dec = make_paged_decode_fn(cfg, PAGED_BS, tp_axis)
    tables = torch.tensor([[1, 2], [3, 4]])
    p0 = torch.from_numpy(d["paged_p0"])[None]
    p1 = torch.from_numpy(d["paged_p1"])[None]
    cut = p1.shape[1] // 2
    out = [pre(params, cache.state, p0, 0, tables[0]),
           pre(params, cache.state, p1[:, :cut], 0, tables[1],
               readout=False),
           pre(params, cache.state, p1[:, cut:], cut, tables[1])]
    out = [o for o in out if o is not None]
    pos = torch.tensor([p0.shape[1], p1.shape[1]])
    for s in range(steps):
        toks = torch.from_numpy(d["paged_toks"][s])
        out.append(dec(params, cache.state, toks, pos, tables))
        pos = pos + 1
    return out


def _paged(d, leg, mesh) -> dict:
    from byteps_tpu_torch.models.convert import shard_params

    cfg, whole = _model(d, leg)
    outs = paged_schedule(cfg, shard_params(whole, mesh), _axis(mesh, "tp"),
                          leg["pool_blocks"], leg["steps"], d)
    return {f"{leg['name']}_logits": np.concatenate(
        [o.numpy().ravel() for o in outs])}


def sched_requests(d, n: int, max_new: int) -> list:
    from byteps_tpu_torch.serve import Request

    return [Request(rid=f"r{i}", prompt=d[f"sched_prompt_{i}"],
                    max_new=max_new) for i in range(n)]


SCHED_KW = {"max_batch": 3, "block_size": PAGED_BS, "pool_blocks": 9,
            "prefill_chunk": 8, "device": "cpu"}


def _sched(d, leg, mesh) -> dict:
    from byteps_tpu_torch.models.convert import shard_params
    from byteps_tpu_torch.serve import Scheduler

    cfg, whole = _model(d, leg)
    tp = _axis(mesh, "tp")
    sched = Scheduler(shard_params(whole, mesh), cfg, tp_axis=tp,
                      **SCHED_KW)
    reqs = sched_requests(d, leg["n"], leg["max_new"])
    res = sched.serve(reqs)
    assert sched.cache.leaked_blocks() == 0
    return {f"{leg['name']}_tokens": np.concatenate(
                [res[r.rid]["tokens"] for r in reqs]),
            f"{leg['name']}_clock": np.array(sched._now())}


def run_legs(io: str, rank: int, world: int) -> dict:
    from byteps_tpu_torch.parallel.mesh import MeshAxes, make_mesh

    d = np.load(f"{io}/in.npz")
    with open(f"{io}/legs.json") as f:
        legs = json.load(f)
    out = {}
    for leg in legs:
        mesh = make_mesh(MeshAxes(**leg["mesh"]))
        kind = leg["kind"]
        if kind in ("hier_opt", "train", "dp_opt"):
            fn = {"hier_opt": multislice_rank._hier_opt,
                  "train": multislice_rank._train, "dp_opt": _dp_opt}[kind]
            with _tier(leg.get("tier")):
                out.update(fn(d, leg, mesh))
            from byteps_tpu_torch.ops.ring_collective_kernels import \
                close_workspaces
            for ax in ("dp", "slice_"):
                if ax in mesh.axis_names:
                    close_workspaces(mesh.axis(ax).group)
            continue
        fn = {"ring_ops": _ring_ops, "generate": _generate,
              "seg_rowpar": _seg_rowpar, "paged": _paged,
              "sched": _sched}[kind]
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
