"""One rank of a two-rank GPT job on the CPU, for
``tests/test_torch_dcn_adapter.py``: a tiny GPT trained by the staged
all-reduce step (``make_gpt_train_step`` over a gloo group), then from the
same seeded weights and batch by ``byteps_tpu_torch.torch``'s
``DistributedOptimizer`` over the summation server, raw and fp16 wire.
Writes each leg's losses, parameter digests and byte counts as JSON.

    python dcn_gpt_rank.py RANK SERVER_PORT STORE_FILE OUT_JSON STEPS
"""

import datetime
import hashlib
import json
import os
import sys

import torch
import torch.distributed as dist


def digest(leaves) -> str:
    flat = torch.cat([p.detach().reshape(-1) for p in leaves])
    return hashlib.sha1(flat.numpy().tobytes()).hexdigest()


def main():
    rank, port, store, out, steps = (int(sys.argv[1]), int(sys.argv[2]),
                                     sys.argv[3], sys.argv[4],
                                     int(sys.argv[5]))
    os.environ.update(DMLC_NUM_WORKER="2", DMLC_NUM_SERVER="1",
                      DMLC_PS_ROOT_URI="127.0.0.1",
                      DMLC_PS_ROOT_PORT=str(port - 1),
                      DMLC_WORKER_ID=str(rank))
    torch.set_num_threads(1)
    import byteps_tpu_torch.torch as bps
    from byteps_tpu_torch.models import (GPTConfig, gpt_init,
                                         make_gpt_train_step,
                                         synthetic_batch)
    from byteps_tpu_torch.models.convert import flat_leaves
    from byteps_tpu_torch.models.gpt import gpt_loss
    from byteps_tpu_torch.models.train import adamw

    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    cfg = GPTConfig.tiny()
    tok, tgt = synthetic_batch(torch.Generator().manual_seed(1 + rank), cfg,
                               2, 16)
    res = {}
    step, _, opt = make_gpt_train_step(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    res["staged_raw"] = {"losses": [], "digests": []}
    for _ in range(steps):
        step(tok, tgt)
        res["staged_raw"]["digests"].append(digest(opt.params))
    bps.init()
    core = bps._state.core
    for leg, comp in (("dcn_raw", "none"), ("dcn_fp16", "fp16")):
        params = gpt_init(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
        params.requires_grad_(True)
        leaves = flat_leaves(params)
        dopt = bps.DistributedOptimizer(adamw(leaves),
                                        params.named_parameters(),
                                        compression=comp)
        bps.broadcast_parameters(dict(params.named_parameters()),
                                 root_rank=0)
        r = res[leg] = {"losses": [], "digests": [], "bytes": []}
        for _ in range(steps):
            before = core.bytes_moved()
            dopt.zero_grad()
            loss = gpt_loss(params, tok, tgt, cfg, chunked_ce=True)
            loss.backward()
            dopt.step()
            r["losses"].append(float(loss))
            r["digests"].append(digest(leaves))
            r["bytes"].append([a - b for a, b in zip(core.bytes_moved(),
                                                     before)])
    res["n_params"] = sum(p.numel() for p in leaves)
    bps.shutdown()
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()
