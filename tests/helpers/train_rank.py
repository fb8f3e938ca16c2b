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
