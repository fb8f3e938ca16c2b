"""Specs of optimizer state (counterpart of
``byteps_tpu/parallel/sharding.py``).

A per-element state tensor (AdamW's ``exp_avg``, ``exp_avg_sq``) has its
parameter's shape and lives sharded as that parameter does, so it takes
the parameter's spec; every other state (a step count) is replicated.
:func:`opt_state_specs` gives those specs for ``torch.optim`` state,
listed in the parameters' order; ``models.convert.gather_leaf`` gathers
a sharded tensor back to full by its spec.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence


def opt_state_specs(state: Sequence[Dict[str, Any]], params: Sequence[Any],
                    param_specs: Sequence[tuple]) -> List[Dict[str, tuple]]:
    """``state[i]`` is the optimizer's state dict of ``params[i]`` (e.g.
    ``[opt.state[p] for p in params]``); returns, for each, a dict of
    the same keys: ``param_specs[i]`` for a tensor shaped like its
    parameter, ``()`` (replicated) for anything else."""
    if not len(state) == len(params) == len(param_specs):
        raise ValueError(f"{len(state)} states, {len(params)} parameters, "
                         f"{len(param_specs)} specs")
    out = []
    for st, p, spec in zip(state, params, param_specs):
        shape = tuple(p.shape)
        out.append({k: (spec if tuple(getattr(v, "shape", ())) == shape
                        and len(shape) > 0 else ())
                    for k, v in st.items()})
    return out
