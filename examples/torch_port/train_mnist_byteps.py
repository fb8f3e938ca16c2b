"""MNIST training over the PyTorch/CUDA port's torch adapter
(``byteps_tpu_torch.torch``): a copy of
``examples/pytorch/train_mnist_byteps.py`` (itself the reference's
``example/pytorch/train_mnist_byteps.py``) on the port, with the same
synthetic MNIST-shaped data from a fixed teacher network and the same
script shape — init, DistributedOptimizer wrap, broadcast, shard-per-
worker training loop. ``--device`` puts the model and each batch on the
card (``cuda``, the default) or the CPU; on the CPU every epoch's line
is the reference example's, character for character.

Start one summation server and the workers through the launcher, each
configured by the ``DMLC_*`` environment (server 0 listens on
``DMLC_PS_ROOT_PORT`` + 1 and exits once every worker shut down; the
worker role spawns ``BYTEPS_LOCAL_SIZE`` workers, each its own
``DMLC_WORKER_ID`` on one host). Two workers, from the repository's root:

    export PYTHONPATH=. DMLC_NUM_WORKER=2 DMLC_NUM_SERVER=1 \\
           DMLC_PS_ROOT_URI=127.0.0.1 DMLC_PS_ROOT_PORT=9000
    DMLC_ROLE=server python -m byteps_tpu_torch.launcher &
    # (or, the server alone: python -m byteps_tpu_torch.server &)
    DMLC_ROLE=worker DMLC_WORKER_ID=0 BYTEPS_LOCAL_SIZE=2 \\
        python -m byteps_tpu_torch.launcher \\
        python examples/torch_port/train_mnist_byteps.py
"""

import argparse
import hashlib

import torch
import torch.nn as nn
import torch.nn.functional as F

import byteps_tpu_torch.torch as bps


class Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(784, 128)
        self.fc2 = nn.Linear(128, 64)
        self.fc3 = nn.Linear(64, 10)

    def forward(self, x):
        x = x.view(-1, 784)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return F.log_softmax(self.fc3(x), dim=1)


def synthetic_mnist(n, seed):
    """MNIST-shaped data labeled by a fixed random teacher (learnable)."""
    g = torch.Generator().manual_seed(1234)      # teacher shared by all
    teacher = torch.randn(784, 10, generator=g)
    gd = torch.Generator().manual_seed(seed)     # data per worker shard
    x = torch.randn(n, 1, 28, 28, generator=gd)
    y = (x.view(n, 784) @ teacher).argmax(1)
    return torch.utils.data.TensorDataset(x, y)


def params_digest(model) -> str:
    """SHA-1 of the parameters' f32 bytes, in registration order."""
    h = hashlib.sha1()
    for p in model.parameters():
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--samples", type=int, default=4096)
    ap.add_argument("--device", default="cuda",
                    help="where the model and batches live (cuda or cpu)")
    ap.add_argument("--print-digest", action="store_true",
                    help="print a SHA-1 of the final parameters")
    args = ap.parse_args()
    device = torch.device(args.device)

    bps.init()
    torch.manual_seed(0)
    model = Net().to(device)
    optimizer = torch.optim.SGD(model.parameters(), lr=args.lr,
                                momentum=0.9)
    optimizer = bps.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
    )
    bps.broadcast_parameters(dict(model.named_parameters()), root_rank=0)

    ds = synthetic_mnist(args.samples // bps.size(), seed=bps.rank())
    loader = torch.utils.data.DataLoader(ds, batch_size=args.batch_size,
                                         shuffle=True)
    for epoch in range(args.epochs):
        model.train()
        total, correct, loss_sum = 0, 0, 0.0
        for x, y in loader:
            x, y = x.to(device), y.to(device)
            optimizer.zero_grad()
            out = model(x)
            loss = F.nll_loss(out, y)
            loss.backward()
            optimizer.step()
            loss_sum += float(loss) * len(y)
            correct += int((out.argmax(1) == y).sum())
            total += len(y)
        print(f"[worker {bps.rank()}] epoch {epoch}: "
              f"loss={loss_sum/total:.4f} acc={correct/total:.3f}",
              flush=True)
    if args.print_digest:
        print(f"[worker {bps.rank()}] params sha1={params_digest(model)}",
              flush=True)
    bps.shutdown()


if __name__ == "__main__":
    main()
