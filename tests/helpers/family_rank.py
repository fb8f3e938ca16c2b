"""One rank of the model families' parity tests
(``tests/helpers/family_parity.py``).

``run_legs(io, rank, world)`` reads ``io/in.pkl`` (each family's
reference weights as numpy trees, its global batch, the legs and the
step count) and, for each leg ``(name, family, mesh, options)``, builds
the port's ``make_<family>_train_step(**options)`` on ``make_mesh`` of
the leg's axes from those weights (whole; each rank keeps its shards),
trains the steps on the global batch (each rank keeps its block) and
returns ``<name>_loss``, ``<name>_params`` (gathered whole, flat in
``jax.tree.leaves`` order) and, for ResNet, ``<name>_bn`` (its running
statistics).

Run as a script (``RANK WORLD STORE IO``), it joins a gloo group over a
FileStore, writes ``IO/out<RANK>.npz`` and prints ``{"ok": true}``: the
form ``tests/test_torch_ring.py``'s ``run_group`` starts. It imports
torch and the port only."""

import json
import pickle
import sys

import numpy as np
import torch

# started as ``python -c`` from the repo's root (``run_group``)
sys.path.insert(0, "tests/helpers")
from tree_leaves import flat  # noqa: E402


def run_legs(io: str, rank: int, world: int) -> dict:
    from byteps_tpu_torch.models import (BertConfig, ResNetConfig, T5Config,
                                         ViTConfig, make_bert_train_step,
                                         make_resnet_train_step,
                                         make_t5_train_step,
                                         make_vit_train_step,
                                         resnet_state_from_numpy,
                                         tree_from_numpy, tree_to_numpy)
    from byteps_tpu_torch.parallel.mesh import MeshAxes, make_mesh

    with open(f"{io}/in.pkl", "rb") as f:
        d = pickle.load(f)
    cfgs = {"bert": BertConfig.tiny(), "vit": ViTConfig.tiny(),
            "t5": T5Config.tiny(), "resnet": ResNetConfig.tiny()}
    factories = {"bert": make_bert_train_step, "vit": make_vit_train_step,
                 "t5": make_t5_train_step,
                 "resnet": make_resnet_train_step}
    out = {}
    for name, fam, axes, kw in d["legs"]:
        mesh = make_mesh(MeshAxes(**axes))
        cfg = cfgs[fam]
        tree = d["trees"][fam]
        if fam == "resnet":
            step, params, _, bn = factories[fam](
                cfg, init_params=tree_from_numpy(tree[0], cfg, device="cpu"),
                init_state=resnet_state_from_numpy(tree[1], cfg,
                                                   device="cpu"),
                device="cpu", mesh=mesh, **kw)
        else:
            step, params, _ = factories[fam](
                cfg, init_params=tree_from_numpy(tree, cfg, device="cpu"),
                device="cpu", mesh=mesh, **kw)
        out[f"{name}_loss"] = np.array(
            [float(step(*d["batches"][fam])) for _ in range(d["steps"])])
        out[f"{name}_params"] = flat(tree_to_numpy(params, mesh=mesh))
        if fam == "resnet":
            out[f"{name}_bn"] = flat(tree_to_numpy(bn))
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
