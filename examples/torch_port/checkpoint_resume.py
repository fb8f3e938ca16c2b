"""Checkpoint/resume on the PyTorch/CUDA port (the counterpart of
``examples/jax/checkpoint_resume.py``).

Checkpointing belongs to the host framework and BytePS contributes the
resume synchronization (``broadcast_parameters``). Here:
``byteps_tpu_torch.checkpoint.Checkpointer`` keeps the last two
step-numbered checkpoints of a GPT trained by the port's train factory
(``make_gpt_train_step``; its batches through ``data.PrefetchLoader``),
and the run then restores the latest one and checks it against the live
parameters. Two multi-worker regimes, two recipes:

- one global group (``BYTEPS_JAX_DISTRIBUTED=1``, formed by the
  launcher's bootstrap before this script runs): the workers train
  data-parallel over the gloo group; worker 0 writes and every worker
  restores (the checkpoint directory is shared);
- hybrid-PS pods (``DMLC_NUM_WORKER`` > 1, a summation server up): the
  pods are separate worlds; pod 0 writes and restores, and every other
  pod receives its values through ``broadcast_parameters``.

Two workers in one global group on one host, from the repository's root::

    DMLC_ROLE=worker DMLC_NUM_WORKER=2 DMLC_WORKER_ID=0 \\
    BYTEPS_LOCAL_SIZE=2 BYTEPS_JAX_DISTRIBUTED=1 PYTHONPATH=. \\
    DMLC_PS_ROOT_URI=127.0.0.1 DMLC_PS_ROOT_PORT=9000 \\
    python -m byteps_tpu_torch.launcher \\
        python examples/torch_port/checkpoint_resume.py --print-digest

Each worker prints ``restored checkpoint matches live params: True``
and, with ``--print-digest``, the SHA-1 of its parameters (with
``--print-launches``, its kernel launch counts).
"""

import argparse
import dataclasses
import hashlib
import json
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from byteps_tpu_torch.checkpoint import Checkpointer
from byteps_tpu_torch.comm.distributed import maybe_init_distributed
from byteps_tpu_torch.common.config import get_config
from byteps_tpu_torch.data import PrefetchLoader
from byteps_tpu_torch.models import GPTConfig, make_gpt_train_step
from byteps_tpu_torch.models.convert import flat_leaves


def params_digest(leaves) -> str:
    """SHA-1 of the parameters' bytes, in the reference's leaf order."""
    h = hashlib.sha1()
    for p in leaves:
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def host_batches(cfg, n, batch, seq, seed):
    """``n`` seeded next-token batches on the host."""
    g = torch.Generator().manual_seed(seed)
    for _ in range(n):
        toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                             generator=g)
        yield toks[:, :-1], toks[:, 1:]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "byteps_tpu_torch_ckpt"))
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--config", default="tiny",
                    choices=("tiny", "gpt2_medium"))
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="where the model and batches live (cuda or cpu)")
    ap.add_argument("--print-digest", action="store_true",
                    help="print a SHA-1 of the final parameters")
    ap.add_argument("--print-launches", action="store_true",
                    help="print this worker's kernel launch counts")
    args = ap.parse_args()

    cfg_env = get_config()
    collective = maybe_init_distributed()     # no-op if already joined
    pods = (not collective) and cfg_env.num_worker > 1
    bps = None
    if pods:
        import byteps_tpu_torch.torch as bps

        bps.init()
    rank = (dist.get_rank() if collective
            else bps.rank() if pods else 0)
    writer = rank == 0

    cfg = getattr(GPTConfig, args.config)()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    device = torch.device(args.device)
    step, params, opt = make_gpt_train_step(
        cfg, device=device,
        generator=torch.Generator(device=device).manual_seed(0))

    # a demo trains from scratch every run: clear stale steps (a real
    # resume job keeps the directory)
    if writer and os.path.isdir(args.ckpt_dir):
        shutil.rmtree(args.ckpt_dir)
    if collective:
        dist.barrier()
    ckpt = Checkpointer(args.ckpt_dir, max_to_keep=2, should_save=writer)
    # every worker of the global group feeds its own seed's batches (its
    # shard); a hybrid pod trains alone on pod 0's
    batches = host_batches(cfg, args.steps, args.batch, args.seq,
                           seed=1 + (rank if collective else 0))
    with PrefetchLoader(batches, device=device) as loader:
        for i, (tok, tgt) in enumerate(loader):
            loss = step(tok, tgt)
            ckpt.save(i + 1, {"params": params_dict(params)})
    ckpt.wait()
    print(f"[worker {rank}] trained {args.steps} steps, "
          f"loss={float(loss):.4f}; checkpoints kept: "
          f"{ckpt.all_steps() if writer else 'n/a'}", flush=True)

    # resume: every rank of the global group restores from the shared
    # directory; otherwise pod 0 restores and the others receive its
    # values through broadcast_parameters
    if collective:
        dist.barrier()
    live = params_dict(params)
    like = {"params": {k: torch.empty_like(v) for k, v in live.items()}}
    if writer or collective:
        restored = ckpt.restore(like)["params"]
    else:
        restored = {k: torch.zeros_like(v) for k, v in live.items()}
    if pods:
        bps.broadcast_parameters(restored, root_rank=0)
    match = all(torch.equal(restored[k], v) for k, v in live.items())
    print(f"[worker {rank}] restored checkpoint matches live params: "
          f"{match}", flush=True)
    if args.print_digest:
        print(f"[worker {rank}] params sha1="
              f"{params_digest(flat_leaves(params))}", flush=True)
    if args.print_launches:
        from byteps_tpu_torch.ops import launches

        print(f"[worker {rank}] launches {json.dumps(dict(launches))}",
              flush=True)
    if pods:
        bps.shutdown()
    if collective:
        dist.barrier()
        dist.destroy_process_group()


def params_dict(params):
    """The parameters as one flat name → tensor dict."""
    return {k: v for k, v in params.named_parameters()}


if __name__ == "__main__":
    main()
