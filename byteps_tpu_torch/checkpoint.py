"""Checkpoint/resume for distributed train state (the port's counterpart
of ``byteps_tpu/checkpoint.py``).

In the reference BytePS, checkpointing belongs to the host framework
(``state_dict`` in the examples) and BytePS contributes the resume
synchronization, ``broadcast_parameters`` / ``broadcast_optimizer_state``.
``byteps_tpu`` checkpoints its sharded global arrays through orbax, and
restores them onto another mesh. The port writes plain files instead,
with the same surface:

- :class:`Checkpointer` — a step-numbered checkpoint directory with
  retention (``max_to_keep``), a cadence (``save_interval_steps``), a
  writer gate (``should_save``) and asynchronous saves. Each step is one
  ``torch.save`` of host copies into ``<dir>/<step>/state.pt`` (a tree
  without tensors: one pickle, ``state.pkl``, so a process that holds
  only numpy state, as the launcher's ``--child-worker``, never imports
  torch), written under a temporary name and committed by an atomic
  rename, so a crash mid-write leaves no step behind. The device-to-host copy (into pinned
  memory) finishes before :meth:`Checkpointer.save` returns — the
  port's optimizers update in place, so a copy still in flight when the
  next step starts would record a mix of two steps — and only the disk
  write runs behind (``async_save``), joined by :meth:`wait`, ``close``
  or the next save.
- Resharding: a state tree comes with a spec tree (``specs=``, one
  partition spec a leaf: a tuple of mesh axes a dimension, ``()`` or None
  for a whole leaf, :data:`RANK_LOCAL` for a leaf each rank holds its
  own of) and its ``mesh``. The file holds whole leaves: ``save``
  gathers a spec'd leaf's shards (collective over the spec's axes, so
  every rank calls it, writer or not) and stacks the ranks' rank-local
  leaves (collective over the world); ``restore`` cuts each rank's block
  of a whole leaf by the target's spec, and its own row of a stacked
  one. A checkpoint written on dp=4 restores onto dp=2 × tp=2.
- :func:`restore` with ``like`` (a tree of tensors, or of the
  :class:`LeafLike` skeleton :func:`abstract_like` makes) lays each leaf
  out as its ``like`` leaf: device, dtype and (this rank's) shape.
- :func:`train_state` / :func:`load_train_state` — the state of the
  port's train factories, ``(step, params, opt)``: the parameters, the
  inner optimizer's moments and step count, the EF residual and
  momentum, and the codec key's seed and count
  (``DistributedOptimizer.state_tree``). With all of it a onebit + EF
  resume is bit-exact.
- :func:`save_checkpoint` / :func:`restore_checkpoint` — one-shot forms.

Hybrid-PS pods (several pods over the summation servers) are separate
worlds: one pod writes (``should_save=bps.rank() == 0``) and the others
receive the restored values through ``broadcast_parameters``
(``examples/torch_port/checkpoint_resume.py``). In one global group
(``BYTEPS_JAX_DISTRIBUTED=1``) every rank calls save and restore.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "Checkpointer",
    "LeafLike",
    "RANK_LOCAL",
    "abstract_like",
    "load_train_state",
    "restore_checkpoint",
    "save_checkpoint",
    "train_state",
]

# the spec of a leaf each rank holds its own of (an EF residual): saved
# as the world's rows stacked, restored as this rank's row
RANK_LOCAL = "rank"
# a tree with tensors is a torch.save file, one without a pickle
_STATE_FILES = ("state.pt", "state.pkl")


def _is_tensor(x) -> bool:
    """A torch tensor, without importing torch: none exists before it."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


@dataclasses.dataclass(frozen=True)
class LeafLike:
    """A leaf's layout without its buffer (the reference's
    ``ShapeDtypeStruct`` with its sharding): this rank's ``shape``, its
    ``dtype`` and ``device``."""

    shape: Tuple[int, ...]
    dtype: "torch.dtype"
    device: "torch.device"


def abstract_like(tree: Any) -> Any:
    """The :class:`LeafLike` skeleton of ``tree`` (tensors become their
    layout; numpy arrays, scalars and None stay) — a restore target "laid
    out as this state" that keeps none of its buffers alive."""
    return _map(lambda x, _: (LeafLike(tuple(x.shape), x.dtype, x.device)
                              if _is_tensor(x) else x), tree, None)


def _map(fn, tree: Any, specs: Any, path: str = "") -> Any:
    """``fn(leaf, spec)`` over a tree of dicts, lists and tuples, with a
    spec tree of the same structure (or None: no specs below)."""
    def sub(k):
        return _spec_at(specs, k, tree)

    if isinstance(tree, dict):
        return {k: _map(fn, v, sub(k), f"{path}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map(fn, v, sub(i), f"{path}/{i}")
               for i, v in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(tree, specs)


def _world() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _gather(t: "torch.Tensor", spec, mesh) -> "torch.Tensor":
    """The whole leaf of this rank's ``t``: its shards gathered by
    ``spec`` on ``mesh``, or the world's rows stacked (rank-local)."""
    import torch
    import torch.distributed as dist

    if spec == RANK_LOCAL:
        n, _ = _world()
        if n == 1:
            return t.unsqueeze(0)
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous())
        return torch.stack(parts)
    if spec and mesh is not None:
        from byteps_tpu_torch.models.convert import gather_leaf

        return gather_leaf(t, tuple(spec), mesh)
    return t


def _cut(whole: "torch.Tensor", spec, mesh) -> "torch.Tensor":
    """This rank's block of a whole leaf (its row of a rank-local one)."""
    if spec == RANK_LOCAL:
        n, rank = _world()
        if whole.shape[0] != n:
            raise ValueError(f"a rank-local leaf saved by {whole.shape[0]} "
                             f"ranks does not restore onto {n}")
        return whole[rank]
    if spec and mesh is not None:
        from byteps_tpu_torch.models.convert import shard_leaf

        return shard_leaf(whole, tuple(spec), mesh)
    return whole


class Checkpointer:
    """Step-numbered checkpoints with retention and asynchronous save.

    ``directory``: root path (created if missing); step ``s`` lands in
    ``directory/<s>/``. ``max_to_keep``: older steps are deleted after a
    newer one commits (None keeps every step). ``save_interval_steps``:
    a ``save()`` off this grid is a no-op returning False, so the train
    loop may call it every step. ``should_save``: the writer gate (False
    on every hybrid pod but one); restore works everywhere.
    ``async_save``: the disk write overlaps the following steps.

    ``last_save`` holds the latest save's timings: ``d2h_ms`` (gathers
    and the device-to-host copy, inside ``save``), ``write_ms`` (the
    disk write, behind it when asynchronous) and ``bytes``."""

    def __init__(self, directory, *, max_to_keep: Optional[int] = 3,
                 save_interval_steps: int = 1, should_save: bool = True,
                 async_save: bool = True) -> None:
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(1, int(save_interval_steps))
        self._should_save = bool(should_save)
        self._async = bool(async_save)
        self._writer: Optional[threading.Thread] = None
        self._writer_err: Optional[BaseException] = None
        self.last_save: Dict[str, float] = {}
        os.makedirs(self.directory, exist_ok=True)

    # -- writing ---------------------------------------------------------
    def save(self, step: int, state: Any, *, force: bool = False,
             specs: Any = None, mesh=None) -> bool:
        """Checkpoint ``state`` (a tree of tensors, numpy arrays and
        scalars) as ``step``; ``specs``/``mesh`` as the module docstring.
        Returns True when a save was started: on the cadence grid and
        past the latest step (``force`` skips both checks), and this
        process a writer. With specs, every rank must call it."""
        step = int(step)
        if not force:
            last = self.latest_step()
            if step % self.save_interval_steps or (
                    last is not None and step <= last):
                return False
        t0 = time.perf_counter()
        host = self._to_host(state, specs, mesh)
        d2h_ms = (time.perf_counter() - t0) * 1e3
        if not self._should_save:
            return False
        self.wait()                 # one write in flight at a time
        nbytes = sum(x.numel() * x.element_size() if _is_tensor(x)
                     else getattr(x, "nbytes", 0)
                     for x in _flat(host))
        self.last_save = {"step": step, "d2h_ms": d2h_ms, "bytes": nbytes}
        if self._async:
            self._writer = threading.Thread(
                target=self._write_guarded, args=(step, host),
                name="byteps-ckpt-writer", daemon=True)
            self._writer.start()
        else:
            self._write(step, host)
        return True

    def _to_host(self, state: Any, specs: Any, mesh) -> Any:
        """Whole leaves on the host, every copy finished: device tensors
        land in pinned memory (copied asynchronously, then one sync)."""
        pending = []

        def put(x, spec):
            if _is_tensor(x):
                import torch

                t = _gather(x.detach(), spec, mesh)
                if t.is_cuda:
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    h.copy_(t, non_blocking=True)
                    pending.append(t.device)
                    return h
                return t.clone()
            if isinstance(x, np.ndarray):
                return x.copy()
            return x

        host = _map(put, state, specs)
        for dev in set(pending):
            sys.modules["torch"].cuda.synchronize(dev)
        return host

    def _write_guarded(self, step: int, host: Any) -> None:
        try:
            self._write(step, host)
        except BaseException as e:  # noqa: BLE001 — re-raised by wait()
            self._writer_err = e

    def _write(self, step: int, host: Any) -> None:
        t0 = time.perf_counter()
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}-"
                           f"{threading.get_ident()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        if any(_is_tensor(x) for x in _flat(host)):
            sys.modules["torch"].save(host,
                                      os.path.join(tmp, _STATE_FILES[0]))
        else:
            with open(os.path.join(tmp, _STATE_FILES[1]), "wb") as f:
                pickle.dump(host, f, protocol=pickle.HIGHEST_PROTOCOL)
        if os.path.isdir(final):     # a forced save of a committed step
            shutil.rmtree(final)
        os.rename(tmp, final)        # the commit
        if self.max_to_keep is not None:
            for old in self._committed()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)),
                              ignore_errors=True)
        self.last_save["write_ms"] = (time.perf_counter() - t0) * 1e3

    def wait(self) -> None:
        """Join an asynchronous write in flight; raise its error."""
        w = self._writer
        if w is not None:
            w.join()
            self._writer = None
        if self._writer_err is not None:
            err, self._writer_err = self._writer_err, None
            raise err

    # -- reading ---------------------------------------------------------
    def _state_file(self, step: int) -> Optional[str]:
        for name in _STATE_FILES:
            path = os.path.join(self.directory, str(step), name)
            if os.path.isfile(path):
                return path
        return None

    def _committed(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and self._state_file(int(n)))

    def all_steps(self) -> List[int]:
        """Committed steps, ascending (a write in flight is joined)."""
        self.wait()
        return self._committed()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any = None, *, step: Optional[int] = None,
                specs: Any = None, mesh=None) -> Any:
        """Restore ``step`` (default: the latest; ``FileNotFoundError``
        when there is none). Without ``like`` the saved tree comes back
        as saved (whole leaves, on the host). With ``like`` (tensors or
        :class:`LeafLike` leaves; numpy arrays, scalars and None) each
        leaf is cut to this rank's block by ``specs`` on ``mesh`` and
        laid out as its ``like`` leaf; a structure, key or shape that
        does not match raises ``ValueError``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint steps under {self.directory}")
        t0 = time.perf_counter()
        path = self._state_file(int(step))
        if path is None:
            raise FileNotFoundError(f"no checkpoint step {step} under "
                                    f"{self.directory}")
        if path.endswith(".pt"):
            import torch

            saved = torch.load(path, map_location="cpu", weights_only=False)
        else:
            with open(path, "rb") as f:
                saved = pickle.load(f)
        out = saved if like is None else _lay_out(saved, like, specs, mesh)
        self.last_restore_ms = (time.perf_counter() - t0) * 1e3
        return out

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "Checkpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _flat(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def _spec_at(specs: Any, k, tree: Any) -> Any:
    """The spec of ``tree``'s entry ``k``: a rank-local subtree stays
    rank-local, a key the spec tree leaves out has none."""
    if specs is None or isinstance(specs, str):
        return specs if specs == RANK_LOCAL else None
    if isinstance(specs, dict):
        return specs.get(k)
    if isinstance(specs, tuple) and not isinstance(tree, tuple):
        return None              # a leaf's spec where a subtree sits
    return specs[k]


def _lay_out(saved: Any, like: Any, specs: Any, mesh,
             path: str = "") -> Any:
    """``saved`` laid out as ``like``, leaf by leaf (``restore``)."""
    if isinstance(like, dict):
        if not isinstance(saved, dict) or set(saved) != set(like):
            held = (sorted(saved) if isinstance(saved, dict)
                    else type(saved).__name__)
            raise ValueError(f"checkpoint at {path or '/'} holds {held}, "
                             f"the target {sorted(like)}")
        return {k: _lay_out(saved[k], v, _spec_at(specs, k, like), mesh,
                            f"{path}/{k}") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(like):
            raise ValueError(f"checkpoint at {path or '/'} does not match "
                             f"the target's {len(like)} entries")
        out = [_lay_out(s, v, _spec_at(specs, i, like), mesh,
                        f"{path}/{i}")
               for i, (s, v) in enumerate(zip(saved, like))]
        return tuple(out) if isinstance(like, tuple) else out
    if like is None:
        if saved is not None:
            raise ValueError(f"checkpoint at {path} holds a value, the "
                             "target None")
        return None
    if isinstance(like, LeafLike) or _is_tensor(like):
        if not _is_tensor(saved):
            raise ValueError(f"checkpoint at {path} holds "
                             f"{type(saved).__name__}, the target a tensor")
        block = _cut(saved, specs, mesh)
        if tuple(block.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint at {path}: this rank's block is "
                             f"{tuple(block.shape)}, the target "
                             f"{tuple(like.shape)}")
        return block.to(device=like.device, dtype=like.dtype, copy=True)
    if isinstance(like, np.ndarray):
        a = saved.numpy() if _is_tensor(saved) else np.asarray(saved)
        if a.shape != like.shape:
            raise ValueError(f"checkpoint at {path}: {a.shape}, the target "
                             f"{like.shape}")
        return a.astype(like.dtype, copy=True)
    return type(like)(saved)


# -- the train factories' state ----------------------------------------------
def train_state(step: int, params, opt, mesh=None) -> Tuple[Dict, Dict]:
    """``(state, specs)`` of a train factory's ``(step, params, opt)``:
    ``state = {"step", "params", "opt"}`` with ``params`` the parameter
    module's nested dict of (live) leaves and ``opt`` its
    ``DistributedOptimizer.state_tree()``; ``specs`` the matching spec
    tree on ``mesh``: each parameter's and per-element moment's
    partition spec, the EF residual and momentum rank-local (each rank's
    own vector). Without a mesh the parameters are whole, and the EF is
    rank-local over the default group. A fresh factory's ``train_state``
    is a restore's ``like``."""
    import torch

    from byteps_tpu_torch.models.convert import (_family_specs,
                                                 _module_tree, flat_specs,
                                                 param_specs)
    from byteps_tpu_torch.models.gpt import GPT

    tree = _module_tree(params)
    ost = opt.state_tree()
    if mesh is not None:
        pspecs = (param_specs(params.cfg, mesh, params.stacked)
                  if isinstance(params, GPT)
                  else _family_specs(params.cfg, mesh))
        flat = flat_specs(pspecs)
    else:
        pspecs, flat = None, [None] * len(opt.params)
    inner_specs = [
        {k: (spec if torch.is_tensor(v) and tuple(v.shape)
             == tuple(p.shape) and v.ndim > 0 else None)
         for k, v in st.items()}
        for st, p, spec in zip(ost["inner"], opt.params, flat)]
    specs = {"step": None, "params": pspecs,
             "opt": {"count": None, "seed": None, "ef": RANK_LOCAL,
                     "momentum": RANK_LOCAL, "inner": inner_specs}}
    return {"step": int(step), "params": tree, "opt": ost}, specs


def load_train_state(params, opt, state: Dict[str, Any]) -> int:
    """Copy a restored :func:`train_state` (laid out as ``params`` and
    ``opt``'s own) into the live ``params`` and ``opt`` in place — the
    factory's step closes over them — and return its step."""
    import torch

    from byteps_tpu_torch.models.convert import _module_tree

    def copy(dst, src, path=""):
        if isinstance(dst, dict):
            for k in dst:
                copy(dst[k], src[k], f"{path}/{k}")
        elif isinstance(dst, list):
            for i, (d, s) in enumerate(zip(dst, src)):
                copy(d, s, f"{path}/{i}")
        else:
            if dst.shape != src.shape:
                raise ValueError(f"params{path}: {tuple(src.shape)} into "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)

    with torch.no_grad():
        copy(_module_tree(params), state["params"])
    opt.load_state_tree(state["opt"])
    return int(state["step"])


def save_checkpoint(directory, step: int, state: Any, specs: Any = None,
                    mesh=None) -> None:
    """One-shot synchronous save of ``state`` as ``step``."""
    with Checkpointer(directory, max_to_keep=None, async_save=False) as ck:
        ck.save(step, state, force=True, specs=specs, mesh=mesh)


def restore_checkpoint(directory, like: Any = None,
                       step: Optional[int] = None, specs: Any = None,
                       mesh=None) -> Any:
    """One-shot restore (the latest step by default), cut for ``mesh``
    and laid out as ``like`` when given."""
    with Checkpointer(directory, max_to_keep=None, async_save=False) as ck:
        return ck.restore(like, step=step, specs=specs, mesh=mesh)
