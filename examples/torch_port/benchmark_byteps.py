"""Synthetic push_pull benchmark over the PyTorch/CUDA port's torch
adapter (``byteps_tpu_torch.torch``): a copy of
``examples/pytorch/benchmark_byteps.py`` on the port. It times
``push_pull_async`` + ``synchronize`` of a synthetic gradient set
(``--tensor-mb`` in ``--num-tensors`` tensors, on ``--device``: the card
by default, whose tensors go through pinned host memory) and prints
worker 0's GB/s.

Start one summation server and the workers through the launcher, each
configured by the ``DMLC_*`` environment (from the repository's root):

    export PYTHONPATH=. DMLC_NUM_WORKER=2 DMLC_NUM_SERVER=1 \\
           DMLC_PS_ROOT_URI=127.0.0.1 DMLC_PS_ROOT_PORT=9000
    DMLC_ROLE=server python -m byteps_tpu_torch.launcher &
    # (or, the server alone: python -m byteps_tpu_torch.server &)
    DMLC_ROLE=worker DMLC_WORKER_ID=0 BYTEPS_LOCAL_SIZE=2 \\
        python -m byteps_tpu_torch.launcher \\
        python examples/torch_port/benchmark_byteps.py
"""

import argparse
import time

import torch

import byteps_tpu_torch.torch as bps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-iters", type=int, default=20)
    ap.add_argument("--tensor-mb", type=float, default=25.0,
                    help="gradient bytes per step (ResNet-50 ≈ 100 MB fp32; "
                         "default smaller for CPU runs)")
    ap.add_argument("--num-tensors", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="where the tensors live (cuda or cpu)")
    args = ap.parse_args()
    device = torch.device(args.device)

    bps.init()
    elems = int(args.tensor_mb * 1e6 / 4 / args.num_tensors)
    tensors = [torch.randn(elems, device=device)
               for _ in range(args.num_tensors)]

    # warmup (declares + inits keys)
    hs = [bps.push_pull_async(t, name=f"bench.{i}")
          for i, t in enumerate(tensors)]
    for h in hs:
        bps.synchronize(h)

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(args.num_iters):
        hs = [bps.push_pull_async(t, name=f"bench.{i}")
              for i, t in enumerate(tensors)]
        for h in hs:
            bps.synchronize(h)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = (time.perf_counter() - t0) / args.num_iters
    gb = args.tensor_mb / 1e3
    if bps.rank() == 0:
        print(f"push_pull: {gb / dt:.3f} GB/s/worker "
              f"({args.tensor_mb:.0f} MB in {dt*1e3:.1f} ms, "
              f"{bps.size()} workers)", flush=True)
    bps.shutdown()


if __name__ == "__main__":
    main()
