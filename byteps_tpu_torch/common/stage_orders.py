"""Canonical pipeline stage-name orders (the port's copy of
``byteps_tpu/common/stage_orders.py``).

The pipelines are the enforcement point: ``DcnCore`` checks its built
stage list against these constants, and every ``PipelineScheduler``
registers its live stage list, so a stage added to a constructor without
updating its constant raises instead of drifting. ``DCN_STAGE_ORDER`` is
the host pipeline of a flat CPU buffer; a CUDA tensor adds ``COPYD2H``
before it and ``COPYH2D`` after it, the names the reference's hybrid
pipeline (``HYBRID_STAGE_ORDER``) uses.

Importing this module registers every order into the scheduler's
stage-order registry (worker pipelines first, server rows after).
"""

from __future__ import annotations

from byteps_tpu_torch.common.scheduler import register_stage_order

# Host-adapter DCN pipeline (DcnCore) — reference core_loops.cc order.
DCN_STAGE_ORDER = ("COMPRESS", "PUSH", "PULL", "DECOMPRESS")
# The reference's jax hybrid pipeline (root-GPU queue list); unsharded mode
# runs the same order without the ALLGATHER tail.
HYBRID_STAGE_ORDER = (("REDUCE", "COPYD2H") + DCN_STAGE_ORDER
                      + ("COPYH2D", "ALLGATHER"))
# The same pipeline for a CUDA tensor: the device-to-host copy first and
# the copy back last, named as in HYBRID_STAGE_ORDER.
CUDA_DCN_STAGE_ORDER = ("COPYD2H",) + DCN_STAGE_ORDER + ("COPYH2D",)
# The reference's jax eager ICI pipeline.
EAGER_STAGE_ORDER = ("PUSHPULL", "SYNC")
# Per-key rows the C++ summation server's own chrome trace emits.
SERVER_STAGE_ORDER = ("PUSH_RECV", "SUM", "PULL_RESP", "ROUND")

register_stage_order(HYBRID_STAGE_ORDER)
register_stage_order(DCN_STAGE_ORDER)
register_stage_order(CUDA_DCN_STAGE_ORDER)
register_stage_order(EAGER_STAGE_ORDER)
register_stage_order(SERVER_STAGE_ORDER)
