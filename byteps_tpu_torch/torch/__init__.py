"""byteps_tpu_torch.torch — the PyTorch framework adapter over the DCN
summation service (the port's counterpart of ``byteps_tpu/torch``).

Reference analog: ``byteps/torch/__init__.py`` + ``byteps/torch/ops.cc`` —
the same public surface (``init``, ``rank``/``size``, ``push_pull``,
``DistributedOptimizer`` with per-parameter gradient hooks,
``broadcast_parameters``, ``broadcast_optimizer_state``), over this
package's credit-scheduled partition pipeline (``common/dcn_adapter.py``)
and its native TCP summation servers (``byteps_tpu_torch/server``).

Tensors on the card take the pipeline's CUDA path: copied to pinned host
memory behind the caller's stream, pushed, pulled, and copied back in
place. CPU tensors take the host path and give exactly the reference
adapter's result. Averages are taken on the host in f32, in both cases,
partition by partition in the pipeline's DECOMPRESS, as the reference
takes them slice by slice: a partition that degraded to this worker's
own contribution (no live summation server, ``BYTEPS_DEGRADED_OK``)
stays that contribution.
"""

from __future__ import annotations

import weakref
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from byteps_tpu_torch.common.config import get_config
from byteps_tpu_torch.common.dcn_adapter import DcnCore, wire_codec_for
from byteps_tpu_torch.common.logging import bps_check, get_logger
from byteps_tpu_torch.common.scheduler import Handle

log = get_logger("torch")


class Compression:
    """Compression choices for the DCN wire (reference:
    byteps/torch/compression.py). ``fp16`` rides the real binary16 wire
    codec — every push and pull moves half the bytes; the server decodes,
    fp32-sums, and re-encodes (partitions under BYTEPS_MIN_COMPRESS_BYTES
    stay raw fp32)."""

    none = "none"
    fp16 = "fp16"


class _TorchState:
    def __init__(self) -> None:
        self.initialized = False
        self.cfg = None
        self.core: Optional[DcnCore] = None


_state = _TorchState()


def init() -> None:
    """Connect to the summation servers and rendezvous (reference:
    ``byteps_init`` — env-driven: DMLC_PS_ROOT_URI/PORT, DMLC_NUM_WORKER,
    DMLC_NUM_SERVER, DMLC_WORKER_ID)."""
    if _state.initialized:
        return
    cfg = get_config()
    _state.cfg = cfg
    _state.core = DcnCore()
    _state.initialized = True
    log.info("byteps_tpu_torch.torch initialized: worker %d/%d",
             cfg.worker_id, cfg.num_worker)


def shutdown() -> None:
    if not _state.initialized:
        return
    _state.core.shutdown()
    _state.initialized = False


def _require_init() -> None:
    bps_check(_state.initialized, "call byteps_tpu_torch.torch.init() first")


def rank() -> int:
    _require_init()
    return _state.cfg.worker_id


def size() -> int:
    _require_init()
    return _state.cfg.num_worker


def local_rank() -> int:
    _require_init()
    return _state.cfg.local_rank


def local_size() -> int:
    _require_init()
    return _state.cfg.local_size


# --- push_pull --------------------------------------------------------------
def push_pull_async(
    tensor: torch.Tensor,
    average: bool = True,
    name: Optional[str] = None,
    priority: Optional[int] = None,
    compression: str = Compression.none,
) -> Handle:
    """In-place async sum (mean) of ``tensor`` across workers.

    Reference: ``byteps_torch_push_pull_async`` (byteps/torch/ops.cc).
    ``synchronize(handle)`` writes the result back into ``tensor``. A
    tensor on the card stays there: it is copied to pinned host memory
    behind the current stream and the result comes back in place.
    """
    _require_init()
    bps_check(name is not None,
              "byteps_tpu_torch.torch.push_pull requires a tensor name (keys "
              "must agree across workers)")
    flat = tensor.detach().to(torch.float32).contiguous().view(-1)
    cuda = flat.is_cuda
    if not cuda:
        flat = flat.numpy()
    handle = _state.core.push_pull_async(
        flat, name, priority, codec=wire_codec_for(compression),
        divisor=size() if average else 1)
    handle.tensor = tensor          # type: ignore[attr-defined]
    return handle


def synchronize(handle: Handle, timeout: Optional[float] = 120.0) -> torch.Tensor:
    """Wait and write the aggregated value back into the original tensor
    (reference: ``synchronize``/``wait_and_clear``). The result was
    averaged partition by partition in DECOMPRESS: the globally summed
    slices divided by ``size()``, while a degraded slice
    (``handle.degraded_parts``) stays the local contribution, which is
    its own average."""
    flat = DcnCore.assemble(handle, timeout)
    tensor: torch.Tensor = handle.tensor  # type: ignore[attr-defined]
    if isinstance(flat, np.ndarray):
        flat = torch.from_numpy(flat)
    elif flat.data_ptr() == tensor.data_ptr() and flat.dtype == tensor.dtype:
        return tensor                   # the result landed in place
    with torch.no_grad():
        tensor.copy_(flat.view(tensor.shape).to(tensor.dtype))
    return tensor


def push_pull(
    tensor: torch.Tensor,
    average: bool = True,
    name: Optional[str] = None,
    priority: Optional[int] = None,
    compression: str = Compression.none,
) -> torch.Tensor:
    return synchronize(
        push_pull_async(tensor, average, name, priority, compression)
    )


# --- broadcast --------------------------------------------------------------
def broadcast_parameters(
    params: Iterable[Tuple[str, torch.Tensor]] | Dict[str, torch.Tensor],
    root_rank: int = 0,
) -> None:
    """Replicate root's values to all workers, in place. Implemented as
    zero-on-non-root + summed push_pull — the reference's own trick
    (byteps/torch/__init__.py broadcast_parameters)."""
    _require_init()
    items = params.items() if isinstance(params, dict) else params
    handles = []
    for pname, p in items:
        if p is None:
            continue
        if rank() != root_rank:
            with torch.no_grad():
                p.zero_()
        handles.append(push_pull_async(
            p, average=False, name=f"byteps_broadcast.{pname}"
        ))
    for h in handles:
        synchronize(h)


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Broadcast optimizer state tensors + hyperparameters from root
    (reference: broadcast_optimizer_state)."""
    _require_init()
    tensors = {}
    for gi, group in enumerate(optimizer.param_groups):
        for k, v in group.items():
            if isinstance(v, (int, float)) and k != "params":
                t = torch.tensor(float(v), dtype=torch.float64)
                tensors[f"opt_group{gi}.{k}"] = (group, k, t)
    for pid, st in optimizer.state.items():
        for k, v in st.items():
            if torch.is_tensor(v):
                tensors[f"opt_state.{pid}.{k}"] = (st, k, v)
            elif isinstance(v, (int, float)):
                t = torch.tensor(float(v), dtype=torch.float64)
                tensors[f"opt_state.{pid}.{k}"] = (st, k, t)
    broadcast_parameters(
        {n: t for n, (_, _, t) in tensors.items()}, root_rank
    )
    for n, (container, k, t) in tensors.items():
        if torch.is_tensor(container.get(k)):
            continue  # broadcast wrote in place
        orig = container[k]
        container[k] = type(orig)(t.item()) if isinstance(orig, (int, float)) else t.item()


# --- DistributedOptimizer ---------------------------------------------------
class _DistributedOptimizer(torch.optim.Optimizer):
    """Wraps a torch optimizer: per-parameter post-accumulate-grad hooks fire
    push_pull as soon as each grad is ready (comm/compute overlap), and
    ``step()`` synchronizes before applying the inner optimizer.

    Reference: byteps/torch DistributedOptimizer (grad-accumulator hooks →
    _push_pull_param_async; synchronize() in step)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters: Iterable[Tuple[str, torch.Tensor]],
                 compression: str = Compression.none,
                 backward_passes_per_step: int = 1):
        self._opt = optimizer
        self._compression = compression
        self._bpps = max(1, backward_passes_per_step)
        self._pass_count = 0
        self._handles: Dict[torch.Tensor, Handle] = {}
        self._names: Dict[torch.Tensor, str] = {}
        self._hooks = []
        named = list(named_parameters)
        bps_check(len({n for n, _ in named}) == len(named),
                  "parameter names must be unique")
        # declaration order = named_parameters order → priorities fixed
        # identically on every worker before any backward runs
        for pname, p in named:
            if p.requires_grad:
                name = f"byteps_push_pull.{pname}"
                self._names[p] = name
                _state.core.registry.declare(name, (p.numel(),), np.float32)
        for pname, p in named:
            if p.requires_grad:
                self._hooks.append(p.register_post_accumulate_grad_hook(
                    self._make_hook()
                ))

    # pass-throughs
    @property
    def param_groups(self):
        return self._opt.param_groups

    @param_groups.setter
    def param_groups(self, v):
        self._opt.param_groups = v

    @property
    def state(self):
        return self._opt.state

    def state_dict(self):
        return self._opt.state_dict()

    def load_state_dict(self, sd):
        return self._opt.load_state_dict(sd)

    def zero_grad(self, set_to_none: bool = True):
        return self._opt.zero_grad(set_to_none=set_to_none)

    def _make_hook(self):
        # the hook lives on the parameter, whose hooks the garbage
        # collector does not traverse: a strong reference to the optimizer
        # (which holds the parameters) would keep both alive for good
        ref = weakref.ref(self)

        def hook(p: torch.Tensor) -> None:
            self = ref()
            if self is None or (self._pass_count + 1) % self._bpps != 0:
                return  # dropped, or accumulating locally this pass
            self._handles[p] = push_pull_async(
                p.grad, average=True, name=self._names[p],
                compression=self._compression,
            )
        return hook

    def synchronize(self) -> None:
        for p, h in self._handles.items():
            synchronize(h)
        self._handles.clear()

    def step(self, closure=None):
        self._pass_count += 1
        if self._pass_count % self._bpps != 0:
            return None  # mid-accumulation: no sync, no step
        self.synchronize()
        out = self._opt.step(closure)
        return out


def DistributedOptimizer(
    optimizer: torch.optim.Optimizer,
    named_parameters: Iterable[Tuple[str, torch.Tensor]],
    compression: str = Compression.none,
    backward_passes_per_step: int = 1,
) -> _DistributedOptimizer:
    return _DistributedOptimizer(optimizer, named_parameters, compression,
                                 backward_passes_per_step)
