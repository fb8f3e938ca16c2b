"""ResNet family (v1.5 bottleneck or basic blocks) with cross-replica
SyncBN.

Counterpart of ``byteps_tpu/models/resnet.py``: BASELINE config 2's model
("ResNet-50 ImageNet, pure all-reduce"). Images arrive NHWC, as the
reference takes them; the convolutions run as ``F.conv2d`` on their
NCHW view, which is PyTorch's channels-last layout, so no copy is made.
The weights keep the reference's HWIO layout leaf for leaf (so a
reference tree converts unchanged and the gradients flatten in its
order) and are viewed as OIHW per op. XLA's "SAME" padding puts the odd
pixel after (the 7×7/2 stem on 224 pads (2, 3), a 3×3/2 on 112 pads
(0, 1)): where the two sides differ the input is padded explicitly with
``F.pad`` (with −inf before the 3×3/2 max pool) and the op runs
unpadded.

Batch norm is the reference's SyncBN, not ``nn.BatchNorm2d``: f32
statistics, the mean and ``E[x²] − mean²`` (the biased variance)
averaged over the data axes in one all-reduce of both (and, in the
backward, the mean of their gradients over the same axes: each rank's
loss depends on every rank's activations through the shared
statistics); running statistics ``m·old + (1 − m)·new`` with
``m = bn_momentum`` (0.9), held apart from the parameters in their own
tree; ``rsqrt(var + 1e-5)`` before the scale. Parallelism: the data axes
only (dp and ``slice_``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from byteps_tpu_torch.models.gpt import ParamTree, _nll
from byteps_tpu_torch.ops.backend import resolve_device
from byteps_tpu_torch.parallel.mesh import collectives


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depths: Tuple[int, ...] = (3, 4, 6, 3)   # resnet50
    width: int = 64
    bottleneck: bool = True
    num_classes: int = 1000
    bn_momentum: float = 0.9
    dtype: torch.dtype = torch.float32

    @classmethod
    def resnet50(cls) -> "ResNetConfig":
        return cls()

    @classmethod
    def resnet18(cls) -> "ResNetConfig":
        return cls(depths=(2, 2, 2, 2), bottleneck=False)

    @classmethod
    def tiny(cls) -> "ResNetConfig":
        """CIFAR-sized test config."""
        return cls(depths=(1, 1), width=16, bottleneck=False,
                   num_classes=10)


def _block_channels(cfg: ResNetConfig, stage: int) -> Tuple[int, int]:
    width = cfg.width * (2 ** stage)
    return width, width * 4 if cfg.bottleneck else width


def _stride(si: int, bi: int) -> int:
    return 2 if (bi == 0 and si > 0) else 1


def resnet_layout(cfg: ResNetConfig):
    """The parameter and running-statistics trees of ``cfg`` with each
    leaf's kind and shape in its place: convolutions ``("conv", kh, kw,
    cin, cout)``, the classifier's ``("fc", cin, classes)``, and vectors
    that start at ``("ones", c)`` (gains, running variances) or
    ``("zeros", c)`` (biases, running means)."""
    def conv(kh, kw, cin, cout):
        return {"w": ("conv", kh, kw, cin, cout),
                "bn": {"g": ("ones", cout), "b": ("zeros", cout)}}

    def stats(c):
        return {"mean": ("zeros", c), "var": ("ones", c)}

    params: Dict[str, Any] = {"stem": conv(7, 7, 3, cfg.width)}
    state: Dict[str, Any] = {"stem": stats(cfg.width)}
    cin = cfg.width
    params["stages"], state["stages"] = [], []
    for si, depth in enumerate(cfg.depths):
        mid, cout = _block_channels(cfg, si)
        blocks, bstates = [], []
        for bi in range(depth):
            if cfg.bottleneck:
                blk = {"conv1": conv(1, 1, cin, mid),
                       "conv2": conv(3, 3, mid, mid),
                       "conv3": conv(1, 1, mid, cout)}
                bst = {"conv1": stats(mid), "conv2": stats(mid),
                       "conv3": stats(cout)}
            else:
                blk = {"conv1": conv(3, 3, cin, mid),
                       "conv2": conv(3, 3, mid, cout)}
                bst = {"conv1": stats(mid), "conv2": stats(cout)}
            if _stride(si, bi) != 1 or cin != cout:
                blk["proj"] = conv(1, 1, cin, cout)
                bst["proj"] = stats(cout)
            blocks.append(blk)
            bstates.append(bst)
            cin = cout
        params["stages"].append(blocks)
        state["stages"].append(bstates)
    params["fc"] = {"w": ("fc", cin, cfg.num_classes),
                    "b": ("zeros", cfg.num_classes)}
    return params, state


def _map_layout(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_layout(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_layout(fn, v) for v in tree]
    return fn(tree)


def resnet_init(cfg: ResNetConfig,
                generator: Optional[torch.Generator] = None,
                device=None) -> Tuple[ParamTree, ParamTree]:
    """``(params, bn_state)`` for ``cfg`` on ``device`` (the card unless
    told otherwise) from ``generator`` (default: seed 0 on that device):
    He-normal convolutions, N(0, 0.01²) classifier, unit gains, zero
    biases; running means 0 and variances 1."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    p_layout, s_layout = resnet_layout(cfg)

    def leaf(spec):
        kind, *shape = spec
        if kind in ("ones", "zeros"):
            return torch.full(shape, float(kind == "ones"),
                              dtype=torch.float32, device=dev)
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        if kind == "fc":
            return w * 0.01
        return w * (2.0 / (shape[0] * shape[1] * shape[2])) ** 0.5

    return (ParamTree(cfg, _map_layout(leaf, p_layout)),
            ParamTree(cfg, _map_layout(leaf, s_layout)))


def resnet_logical_specs(cfg: ResNetConfig) -> Any:
    """Every leaf replicated (a data-parallel family): an empty logical
    tuple each."""
    return _map_layout(lambda _: (), resnet_layout(cfg)[0])


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: ``ceil(n / s)`` outputs,
    the odd pixel after."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1
          ) -> torch.Tensor:
    """NCHW ``x`` convolved with the HWIO weight ``w`` (cast to x's
    dtype, viewed OIHW), "SAME" padding at ``stride``."""
    kh, kw = w.shape[:2]
    (t, b), (l, r) = (_same_pads(x.shape[2], kh, stride),
                      _same_pads(x.shape[3], kw, stride))
    w = w.to(x.dtype).permute(3, 2, 0, 1)
    if t == b and l == r:
        return F.conv2d(x, w, stride=stride, padding=(t, l))
    return F.conv2d(F.pad(x, (l, r, t, b)), w, stride=stride)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """The stem's 3×3/2 max pool, "SAME" padded with −inf."""
    (t, b), (l, r) = _same_pads(x.shape[2], 3, 2), _same_pads(x.shape[3],
                                                              3, 2)
    if t or b or l or r:
        x = F.pad(x, (l, r, t, b), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


class _DataMean(torch.autograd.Function):
    """The mean over a data axis's ranks, forward and backward: each
    rank's loss reads the shared statistics, so the gradient of a rank's
    own statistics is the mean of every rank's gradient of them."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        out = x.clone()
        dist.all_reduce(out, group=axis.group)
        collectives["syncbn_allreduce_fwd"] += 1
        return out / axis.size

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.axis.group)
        collectives["syncbn_allreduce_bwd"] += 1
        return g / ctx.axis.size, None


def _sync_bn(x, bn, st, data_axis, train: bool, momentum: float):
    """SyncBN over NCHW ``x``; returns ``(y, new running stats)``."""
    xf = x.float()
    if train:
        stats = torch.stack([xf.mean(dim=(0, 2, 3)),
                             (xf * xf).mean(dim=(0, 2, 3))])
        if data_axis is not None and data_axis.size > 1:
            stats = _DataMean.apply(stats, data_axis)
        mean, sq = stats[0], stats[1]
        var = sq - mean * mean
        with torch.no_grad():
            new_st = {"mean": momentum * st["mean"] + (1 - momentum) * mean,
                      "var": momentum * st["var"] + (1 - momentum) * var}
    else:
        mean, var = st["mean"], st["var"]
        new_st = {"mean": mean, "var": var}

    def c(t):
        return t[None, :, None, None]

    y = (xf - c(mean)) * c(torch.rsqrt(var + 1e-5)) * c(bn["g"]) + c(bn["b"])
    return y.to(x.dtype), new_st


def _conv_bn(x, p, st, data_axis, train, momentum, stride=1, relu=True):
    y = _conv(x, p["w"], stride)
    y, new_st = _sync_bn(y, p["bn"], st, data_axis, train, momentum)
    return (F.relu(y) if relu else y), new_st


def resnet_forward(params, state, images: torch.Tensor, cfg: ResNetConfig,
                   dp_axis=None, train: bool = True):
    """NHWC images → ``(f32 logits, new running statistics)`` (a nested
    dict of tensors shaped like ``state``). ``dp_axis`` (an ``Axis``,
    the data axes joined) synchronizes the batch statistics."""
    mom = cfg.bn_momentum
    x = images.to(cfg.dtype).permute(0, 3, 1, 2)      # NCHW, channels last
    new_state: Dict[str, Any] = {"stages": []}
    x, new_state["stem"] = _conv_bn(x, params["stem"], state["stem"],
                                    dp_axis, train, mom, stride=2)
    x = _max_pool(x)
    for si, blocks in enumerate(params["stages"]):
        bstates: List[Any] = []
        for bi, blk in enumerate(blocks):
            st = state["stages"][si][bi]
            nst: Dict[str, Any] = {}
            stride = _stride(si, bi)
            identity = x
            if cfg.bottleneck:
                y, nst["conv1"] = _conv_bn(x, blk["conv1"], st["conv1"],
                                           dp_axis, train, mom)
                y, nst["conv2"] = _conv_bn(y, blk["conv2"], st["conv2"],
                                           dp_axis, train, mom, stride=stride)
                y, nst["conv3"] = _conv_bn(y, blk["conv3"], st["conv3"],
                                           dp_axis, train, mom, relu=False)
            else:
                y, nst["conv1"] = _conv_bn(x, blk["conv1"], st["conv1"],
                                           dp_axis, train, mom, stride=stride)
                y, nst["conv2"] = _conv_bn(y, blk["conv2"], st["conv2"],
                                           dp_axis, train, mom, relu=False)
            if "proj" in blk:
                identity, nst["proj"] = _conv_bn(
                    x, blk["proj"], st["proj"], dp_axis, train, mom,
                    stride=stride, relu=False)
            x = F.relu(y + identity)
            bstates.append(nst)
        new_state["stages"].append(bstates)
    x = x.mean(dim=(2, 3)).float()                     # global average pool
    return x @ params["fc"]["w"] + params["fc"]["b"], new_state


def resnet_loss(params, state, images: torch.Tensor, labels: torch.Tensor,
                cfg: ResNetConfig, dp_axis=None, train: bool = True):
    """``(softmax CE, new running statistics)``; the rank's own mean
    (the train factory's contract)."""
    logits, new_state = resnet_forward(params, state, images, cfg,
                                       dp_axis=dp_axis, train=train)
    return _nll(logits, labels).mean(), new_state

