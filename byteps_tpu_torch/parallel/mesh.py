"""The device mesh of the port: named axes over the ranks of a
``torch.distributed`` job.

Counterpart of ``byteps_tpu/parallel/mesh.py``. The reference's mesh is a
grid of devices with named axes that ``shard_map`` code names in its
collectives; here each rank is one process, and a named axis is the
process group of the ranks that differ from this one along that axis
only. Axis order is the reference's, outermost first:

    (slice_, pp, dp, sp, tp, ep)   — any axis of size 1 may be omitted.

Ranks are laid out row-major in that order, so rank r sits where the
reference's device r sits in its grid (``jax.make_mesh`` over
``jax.devices()``): the parity tests rely on it. The line of an axis is
its ranks in increasing order, which is also their index along the axis
and their rank in the axis's group.

:meth:`Mesh.axes` joins several axes into one: the ranks that differ
from this one along those axes only, indexed row-major over them in the
mesh's order (``("slice_", "dp")``: slice index · n_dp + dp index), the
counterpart of a ``shard_map`` collective over a tuple of axis names
(the reference's ``psum(x, (dcn_axis, axis))``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch.distributed as dist

#: The axis names, outermost first.
AXIS_ORDER = ("slice_", "pp", "dp", "sp", "tp", "ep")

#: Collectives issued over mesh axes, one plain integer per kind, bumped
#: where each is issued: the tp sums of the Megatron pair forward and
#: backward, the sp ring's k/v rotations each way, the vocab-parallel
#: readout's combines, the pipeline's stage-to-stage shifts each way,
#: the MoE dispatch and combine exchanges over ep each way, the train
#: step's sums of the gradients over sp, pp and ep and its broadcasts
#: over tp of the replicated leaves' aggregate; the hierarchical
#: multi-slice aggregation's raw reduce-scatter and all-gather over dp
#: (``optimizer.py``); ZeRO-3's gathers of a parameter group in the
#: forward and again in a rematerialized backward, its reduce-scatters
#: of the gradients, and its one sum of the segment gradients over the
#: data axis that replicates them (``parallel/zero3.py``); SyncBN's
#: all-reduce of a layer's batch statistics over the data axes forward
#: and of their gradients backward (``models/resnet.py``).
collectives: Dict[str, int] = {
    "tp_allreduce_fwd": 0, "tp_allreduce_bwd": 0,
    "sp_rotate_fwd": 0, "sp_rotate_bwd": 0,
    "vocab_allreduce_fwd": 0, "vocab_allreduce_bwd": 0,
    "pp_shift_fwd": 0, "pp_shift_bwd": 0,
    "ep_all_to_all_fwd": 0, "ep_all_to_all_bwd": 0,
    "sp_grad_sum": 0, "pp_grad_sum": 0, "ep_grad_sum": 0,
    "tp_broadcast": 0,
    "hier_dp_reduce_scatter": 0, "hier_dp_all_gather": 0,
    "zero3_gather_fwd": 0, "zero3_gather_bwd": 0,
    "zero3_reduce_scatter": 0, "zero3_grad_sum": 0,
    "syncbn_allreduce_fwd": 0, "syncbn_allreduce_bwd": 0}


def reset_collectives() -> None:
    for k in collectives:
        collectives[k] = 0


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Named axis sizes for :func:`make_mesh`. Size 1 disables an axis."""

    dp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1
    slice_: int = 1

    @property
    def total(self) -> int:
        return self.dp * self.tp * self.sp * self.pp * self.ep * self.slice_

    @property
    def per_slice(self) -> int:
        return self.dp * self.tp * self.sp * self.pp * self.ep

    def as_dict(self) -> Dict[str, int]:
        return {"slice_": self.slice_, "pp": self.pp, "dp": self.dp,
                "sp": self.sp, "tp": self.tp, "ep": self.ep}


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its ``size``, this rank's
    ``index`` along it, the global ``ranks`` of its line (index order)
    and their process ``group`` (None at size 1, where no collective
    runs). Model code takes these where the reference takes axis names."""

    name: str
    size: int
    index: int
    ranks: Tuple[int, ...]
    group: Optional[object] = None


class Mesh:
    """This rank's place in a named grid of ranks: ``axis_names`` and
    ``shape`` as the reference's ``Mesh``, plus :meth:`axis` (an
    :class:`Axis`), :meth:`axes` (several joined), :meth:`axis_size`,
    :meth:`axis_index` and :meth:`group`."""

    def __init__(self, axes: Dict[str, Axis], rank: int):
        self._axes = axes
        self.rank = rank
        self.axis_names: Tuple[str, ...] = tuple(axes)
        self.shape: Dict[str, int] = {n: a.size for n, a in axes.items()}
        self._joined: Dict[Tuple[str, ...], Axis] = {}

    def axis(self, name: str) -> Axis:
        if name not in self._axes:
            raise KeyError(f"mesh has no axis {name!r}; axes are "
                           f"{self.axis_names}")
        return self._axes[name]

    def axis_size(self, name: str) -> int:
        return self.axis(name).size

    def axis_index(self, name: str) -> int:
        return self.axis(name).index

    def group(self, name: str):
        return self.axis(name).group

    def axes(self, names: Sequence[str]) -> Axis:
        """The axes ``names`` (those of them the mesh has) joined into one
        :class:`Axis`: the ranks that differ from this one along those
        axes only, indexed row-major over them in the mesh's order
        (outermost first, as the group ranks them), its name the names
        joined by ``+``. One named axis is that axis; none
        (or all of size 1) is this rank alone.

        Collective the first time a tuple is asked for: every rank of the
        job asks for it (in the same order as every other such tuple),
        and each creates every line's group, lines in increasing order of
        their first rank; later calls return the same :class:`Axis`."""
        live = tuple(n for n in self.axis_names if n in names
                     and self._axes[n].size > 1)
        if len(live) <= 1:
            return (self._axes[live[0]] if live else
                    Axis("+".join(names), 1, 0, (self.rank,)))
        if live in self._joined:
            return self._joined[live]
        order = list(self.axis_names)
        sizes = [self._axes[n].size for n in order]
        pos = [order.index(n) for n in live]
        inner = [sizes[i] for i in pos]
        # every line: the coordinates outside ``live`` fixed
        others = [1 if i in pos else s for i, s in enumerate(sizes)]
        mine = _unravel(self.rank, sizes)
        out = None
        for line in range(math.prod(others)):
            c = _unravel(line, others)
            ranks = []
            for j in range(math.prod(inner)):
                for i, v in zip(pos, _unravel(j, inner)):
                    c[i] = v
                ranks.append(_ravel(c, sizes))
            group = dist.new_group(ranks)
            if self.rank in ranks:
                out = Axis("+".join(live), len(ranks),
                           _ravel([mine[i] for i in pos], inner),
                           tuple(ranks), group)
        self._joined[live] = out
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _unravel(r: int, sizes: Sequence[int]) -> List[int]:
    coords = []
    for s in reversed(sizes):
        coords.append(r % s)
        r //= s
    return coords[::-1]


def _ravel(coords: Sequence[int], sizes: Sequence[int]) -> int:
    r = 0
    for c, s in zip(coords, sizes):
        r = r * s + c
    return r


def layout(axes: MeshAxes) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """The mesh's axis names and sizes, outermost first: the axes of size
    > 1, or every axis at size 1 when there is none."""
    present = [(name, s) for name, s in axes.as_dict().items() if s > 1]
    if not present:
        return AXIS_ORDER, (1,) * len(AXIS_ORDER)
    return tuple(n for n, _ in present), tuple(s for _, s in present)


def rank_coords(axes: MeshAxes, rank: int) -> Dict[str, int]:
    """Rank ``rank``'s index along each axis of the mesh (row-major)."""
    names, sizes = layout(axes)
    return dict(zip(names, _unravel(rank, sizes)))


def make_mesh(axes: MeshAxes) -> Mesh:
    """The mesh of ``axes`` over the ranks of the default process group
    (one rank when none is initialized), with only the axes of size > 1;
    on one rank every axis at size 1, as the reference exposes them.

    Collective: every rank of the job calls it, and each creates every
    line's group (``dist.new_group``) in the same order, axis by axis,
    lines in increasing order of their first rank; a rank keeps the
    groups of its own lines."""
    n, rank = _world()
    if axes.total != n:
        raise ValueError(f"mesh axes {axes.as_dict()} require {axes.total} "
                         f"ranks, have {n}")
    names, sizes = map(list, layout(axes))
    if axes.total == 1:
        return Mesh({name: Axis(name, 1, 0, (rank,)) for name in names},
                    rank)
    mine = _unravel(rank, sizes)
    out: Dict[str, Axis] = {}
    for ai, name in enumerate(names):
        # every line of this axis: the other coordinates fixed
        others = sizes[:ai] + [1] + sizes[ai + 1:]
        for line in range(n // sizes[ai]):
            base = _unravel(line, others)
            ranks = tuple(_ravel(base[:ai] + [i] + base[ai + 1:], sizes)
                          for i in range(sizes[ai]))
            group = dist.new_group(list(ranks))
            if rank in ranks:
                out[name] = Axis(name, sizes[ai], mine[ai], ranks, group)
    return Mesh(out, rank)


def factor_devices(n: int, want_tp: int = 2, want_sp: int = 2,
                   want_pp: int = 1, want_ep: int = 1,
                   n_slices: int = 1) -> MeshAxes:
    """Heuristic factorization of ``n`` ranks onto (slice_, pp, dp, sp,
    tp, ep), the reference's: ``n_slices`` carved off first (it must
    divide ``n``), then within a slice ep, tp, sp and pp where each
    divides what is left, and dp takes the rest. A factor that does not
    divide falls back to 1."""
    if n_slices < 1 or n % n_slices != 0:
        raise ValueError(f"{n} devices cannot split into {n_slices} slices")
    per_slice = n // n_slices

    def carve(rem: int, want: int) -> int:
        return want if want > 1 and rem % want == 0 and rem >= want else 1

    rem = per_slice
    ep = carve(rem, want_ep)
    rem //= ep
    tp = carve(rem, want_tp)
    rem //= tp
    sp = carve(rem, want_sp)
    rem //= sp
    pp = carve(rem, want_pp)
    rem //= pp
    return MeshAxes(dp=rem, tp=tp, sp=sp, pp=pp, ep=ep, slice_=n_slices)
