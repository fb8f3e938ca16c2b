"""One Partitioner for the whole mesh: logical axes → mesh axes.

Counterpart of ``byteps_tpu/parallel/partitioner.py``. Model code names
each dimension of a leaf by meaning (``embed``, ``mlp``, ``heads``,
``kv``, ``vocab``, ``expert``, ``stage``, ``batch``, ``seq``); one rule
table per model family maps those names onto mesh axes (``slice_``,
``pp``, ``dp``, ``sp``, ``tp``, ``ep``). A spec is a tuple with one
mesh-axis name (a tuple of names for several axes, outermost first, or
``None``) per dimension of a leaf; an all-replicated leaf's spec is
``()``, as ``tuple(PartitionSpec())`` is in the reference.

:class:`Partitioner` holds a :class:`~byteps_tpu_torch.parallel.mesh.Mesh`
and a family's rules: the axis names (``.dp``/``.tp``/``.sp``...), the
parameter specs (:meth:`Partitioner.param_specs`), the batch spec
(:meth:`Partitioner.batch_spec`), and this rank's block of a global batch
(:meth:`Partitioner.local_batch`, the counterpart of ``batch_sharding``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

from byteps_tpu_torch.parallel.mesh import Mesh

#: Where one logical axis lands: ``None`` replicates; a tuple shards over
#: several mesh axes (outermost first).
AxisTarget = Union[None, str, Tuple[Optional[str], ...]]

#: A leaf's spec: one entry per dimension.
Spec = Tuple[AxisTarget, ...]

LOGICAL_AXES = ("batch", "seq", "embed", "mlp", "heads", "kv", "vocab",
                "expert", "stage")

_BASE_RULES: Dict[str, AxisTarget] = {
    "batch": ("slice_", "dp"),   # data parallel: DCN outermost, then dp
    "seq": "sp",                 # sequence parallel (ring attention)
    "embed": None,               # residual stream stays replicated
    "mlp": "tp",                 # Megatron col/row: ffn hidden over tp
    "heads": "tp",               # attention heads over tp
    "kv": "tp",                  # kv heads over tp (= heads unless GQA)
    "vocab": None,               # embedding / readout replicated
    "expert": "ep",              # MoE expert dim
    "stage": "pp",               # pipeline stage dim (stacked blocks)
}

#: Per-family rule tables, the reference's.
FAMILY_RULES: Dict[str, Dict[str, AxisTarget]] = {
    "gpt": dict(_BASE_RULES),
    "bert": dict(_BASE_RULES),
    "t5": dict(_BASE_RULES),
    "vit": dict(_BASE_RULES),
    "resnet": dict(_BASE_RULES),
    "moe_gpt": {**_BASE_RULES, "batch": ("slice_", "dp", "ep")},
}

#: Which logical dims a data batch carries, per family.
FAMILY_BATCH_DIMS: Dict[str, Tuple[str, ...]] = {
    "gpt": ("batch", "seq"),
    "bert": ("batch", "seq"),
    "t5": ("batch", "seq"),
    "moe_gpt": ("batch", "seq"),
    "vit": ("batch",),
    "resnet": ("batch",),
}


def _is_logical_leaf(node: Any) -> bool:
    return isinstance(node, tuple) and all(
        n is None or isinstance(n, str) for n in node)


def _filter_target(target: AxisTarget,
                   axis_names: Optional[Sequence[str]]) -> AxisTarget:
    """Drop ``None`` entries and (with ``axis_names``) mesh axes that do
    not exist; collapse to a bare name or ``None`` where possible."""
    if target is None:
        return None
    if isinstance(target, str):
        target = (target,)
    present = tuple(a for a in target
                    if a is not None
                    and (axis_names is None or a in axis_names))
    if not present:
        return None
    return present if len(present) > 1 else present[0]


def resolve_spec(logical: Tuple[Optional[str], ...],
                 rules: Mapping[str, AxisTarget],
                 axis_names: Optional[Sequence[str]] = None) -> Spec:
    """One logical leaf → its spec. ``axis_names`` filters rule targets
    to the mesh's axes (None trusts the rules as given). An
    all-replicated leaf canonicalizes to ``()``."""
    entries = []
    for name in logical:
        if name is None:
            entries.append(None)
            continue
        if name not in LOGICAL_AXES:
            raise ValueError(f"unknown logical axis {name!r}; "
                             f"expected one of {LOGICAL_AXES}")
        entries.append(_filter_target(rules.get(name), axis_names))
    if all(e is None for e in entries):
        return ()
    return tuple(entries)


def _map_tree(fn, tree: Any) -> Any:
    if _is_logical_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    raise TypeError(f"not a logical spec tree node: {tree!r}")


def resolve_specs(logical_tree: Any, rules: Mapping[str, AxisTarget],
                  axis_names: Optional[Sequence[str]] = None) -> Any:
    """:func:`resolve_spec` over a tree (dicts and lists) whose leaves are
    logical tuples."""
    return _map_tree(lambda leaf: resolve_spec(leaf, rules, axis_names),
                     logical_tree)


def rules_from_axes(tp_axis: Optional[str] = None,
                    sp_axis: Optional[str] = None,
                    dp_axis: Optional[str] = None,
                    ep_axis: Optional[str] = None,
                    pp_axis: Optional[str] = None,
                    slice_axis: Optional[str] = None
                    ) -> Dict[str, AxisTarget]:
    """Rule table from explicit axis names (the ``*_param_specs(cfg,
    tp_axis)`` wrappers' bridge)."""
    return {
        "batch": (slice_axis, dp_axis),
        "seq": sp_axis,
        "embed": None,
        "mlp": tp_axis,
        "heads": tp_axis,
        "kv": tp_axis,
        "vocab": None,
        "expert": ep_axis,
        "stage": pp_axis,
    }


def stacked_logical_specs(logical_tree: Any) -> Any:
    """Prepend the ``stage`` logical axis to every leaf: the logical specs
    of a pipeline slab stacked on a leading layer axis
    (``parallel.pipeline.stack_blocks``)."""
    return _map_tree(lambda leaf: ("stage",) + leaf, logical_tree)


#: Each config type's logical-spec table: (module, function).
_LOGICAL_SPECS = {
    "GPTConfig": ("gpt", "gpt_logical_specs"),
    "MoEGPTConfig": ("moe_gpt", "moe_gpt_logical_specs"),
    "BertConfig": ("bert", "bert_logical_specs"),
    "T5Config": ("t5", "t5_logical_specs"),
    "ViTConfig": ("vit", "vit_logical_specs"),
    "ResNetConfig": ("resnet", "resnet_logical_specs"),
}


def _logical_specs_for(cfg: Any) -> Any:
    import importlib

    name = type(cfg).__name__
    if name not in _LOGICAL_SPECS:
        raise TypeError(f"no logical-spec table for config type {name}")
    mod, fn = _LOGICAL_SPECS[name]
    return getattr(importlib.import_module(f"byteps_tpu_torch.models.{mod}"),
                   fn)(cfg)


_FAMILY_BY_CONFIG = {"GPTConfig": "gpt", "MoEGPTConfig": "moe_gpt",
                     "BertConfig": "bert", "T5Config": "t5",
                     "ViTConfig": "vit", "ResNetConfig": "resnet"}


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec names, in order."""
    out = []
    for part in spec:
        if part is None:
            continue
        out.extend((part,) if isinstance(part, str) else part)
    return tuple(out)


def block_of(size: int, target: AxisTarget, mesh: Mesh) -> slice:
    """This rank's block of a dimension of ``size`` split over ``target``
    (outermost axis first): the slice it holds."""
    if target is None:
        return slice(0, size)
    axes = (target,) if isinstance(target, str) else target
    n, idx = 1, 0
    for a in axes:
        n *= mesh.axis_size(a)
        idx = idx * mesh.axis_size(a) + mesh.axis_index(a)
    if size % n:
        raise ValueError(f"a dimension of {size} does not split over "
                         f"{axes} ({n} blocks)")
    b = size // n
    return slice(idx * b, (idx + 1) * b)


@dataclasses.dataclass
class Partitioner:
    """Mesh + logical-axis rules in one object: mesh axis names
    (``.dp``/``.tp``/...), parameter specs, the batch spec and this
    rank's block of a batch."""

    mesh: Mesh
    family: str = "gpt"
    overrides: Optional[Mapping[str, AxisTarget]] = None

    def __post_init__(self):
        base = FAMILY_RULES.get(self.family)
        if base is None:
            raise ValueError(f"unknown model family {self.family!r}; "
                             f"have {sorted(FAMILY_RULES)}")
        self.rules: Dict[str, AxisTarget] = dict(base)
        if self.overrides:
            self.rules.update(self.overrides)

    @classmethod
    def for_config(cls, cfg: Any, mesh: Mesh,
                   overrides: Optional[Mapping[str, AxisTarget]] = None
                   ) -> "Partitioner":
        family = _FAMILY_BY_CONFIG.get(type(cfg).__name__)
        if family is None:
            raise TypeError(f"no family for config type {type(cfg).__name__}")
        return cls(mesh, family=family, overrides=overrides)

    # -- mesh axis accessors -------------------------------------------
    def _axis(self, name: str) -> Optional[str]:
        return name if name in self.mesh.axis_names else None

    @property
    def dp(self) -> Optional[str]:
        return self._axis("dp")

    @property
    def tp(self) -> Optional[str]:
        return self._axis("tp")

    @property
    def sp(self) -> Optional[str]:
        return self._axis("sp")

    @property
    def pp(self) -> Optional[str]:
        return self._axis("pp")

    @property
    def ep(self) -> Optional[str]:
        return self._axis("ep")

    @property
    def slice_(self) -> Optional[str]:
        return self._axis("slice_")

    def axis_size(self, name: str) -> int:
        return (self.mesh.axis_size(name) if name in self.mesh.axis_names
                else 1)

    def mesh_axes(self, logical: str) -> AxisTarget:
        """Mesh axis (or axes) one logical axis lands on, filtered to the
        mesh's axes; ``None`` replicates."""
        if logical not in LOGICAL_AXES:
            raise ValueError(f"unknown logical axis {logical!r}")
        return _filter_target(self.rules.get(logical), self.mesh.axis_names)

    # -- specs ----------------------------------------------------------
    def spec(self, *logical: Optional[str]) -> Spec:
        return resolve_spec(tuple(logical), self.rules, self.mesh.axis_names)

    def resolve(self, logical_tree: Any) -> Any:
        return resolve_specs(logical_tree, self.rules, self.mesh.axis_names)

    def param_specs(self, cfg: Any, stacked: bool = False) -> Any:
        """The spec tree of a model config's parameters; ``stacked``: the
        blocks as one pipeline slab (``"blocks"`` one block's specs with
        the ``stage`` axis first, :func:`stacked_logical_specs`)."""
        logical = _logical_specs_for(cfg)
        if stacked:
            logical["blocks"] = stacked_logical_specs(logical["blocks"][0])
        return self.resolve(logical)

    def batch_spec(self, dims: Optional[Tuple[str, ...]] = None) -> Spec:
        if dims is None:
            dims = FAMILY_BATCH_DIMS[self.family]
        return self.spec(*dims)

    def local_batch(self, x, dims: Optional[Tuple[str, ...]] = None):
        """This rank's block of a global batch ``x`` (``(B, S)`` for the
        GPT family, a tensor or numpy array): its rows of the batch axes
        and its slice of the sequence, replicated over tp."""
        spec = self.batch_spec(dims)
        idx = tuple(block_of(x.shape[d], spec[d] if d < len(spec) else None,
                             self.mesh) for d in range(x.ndim))
        return x[idx]
