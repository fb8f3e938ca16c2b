"""Device-mesh helpers (the port's counterpart of
``byteps_tpu/comm/mesh.py``).

The reference coordinates GPU ranks through env vars and unix sockets;
``byteps_tpu`` makes the rank table a ``jax.sharding.Mesh``. The port's
mesh is :class:`~byteps_tpu_torch.parallel.mesh.Mesh` over the ranks of
the default ``torch.distributed`` group (the global group of
``comm.distributed``); one rank a process.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from byteps_tpu_torch.parallel.mesh import Mesh, MeshAxes, _world, make_mesh

__all__ = ["local_device_count", "device_mesh"]


def local_device_count() -> int:
    """The cards this process sees."""
    return torch.cuda.device_count()


def device_mesh(shape: Optional[Sequence[int]] = None,
                axis_names: Optional[Tuple[str, ...]] = None) -> Mesh:
    """A mesh over the world's ranks; the default is 1-D on the dp axis.
    ``axis_names`` are the port's (``MeshAxes``' fields: dp, tp, sp, pp,
    ep, slice_). Collective, as :func:`make_mesh`."""
    if shape is None:
        shape = (_world()[0],)
    if axis_names is None:
        if len(shape) != 1:
            raise ValueError("a mesh of several axes needs axis_names "
                             "(the port's axes are named: dp, tp, sp, pp, "
                             "ep, slice_)")
        axis_names = ("dp",)
    if len(axis_names) != len(shape):
        raise ValueError(f"{len(axis_names)} names for {len(shape)} axes")
    return make_mesh(MeshAxes(**dict(zip(axis_names, map(int, shape)))))
