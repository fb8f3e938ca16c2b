"""byteps_tpu_torch — the PyTorch/CUDA port of ``byteps_tpu``.

A package of its own beside the JAX reference: it imports ``torch``
and never ``jax`` or any module of ``byteps_tpu``. Every Pallas kernel
on a ported path becomes a kernel written by hand for Hopper
(``ops/csrc``), built with ``nvcc`` at first use; beside each kernel
sits its plain PyTorch version, which CPU tensors take. Entry points
run on the card unless the caller passes ``device="cpu"``.

Ported so far, on thirteen hand-written kernels: serving
(``serve.Scheduler`` over the paged KV cache, multi-tenant LoRA through
``serve.AdapterPool``, speculative decoding, the multi-replica
``serve.Router`` with disaggregated prefill/decode and KV migration,
over a socket too: ``serve.kv_socket``); training (``models``' train
factories for GPT, BERT, ViT, T5 and ResNet, every codec of
``compression``, the staged and ring wire tiers of ``comm.ici``, ZeRO-1
and ZeRO-3, accumulation, and ``parallel``'s dp, tp, sp, pp, ep and
``slice_`` meshes); the DCN tier (``server``, ``common.dcn_adapter``,
``torch``, ``eager``) with its robustness and elastic membership; and
the process tier (``launcher`` with its ``Supervisor``,
``comm.distributed``, ``checkpoint``, ``data``, ``common.socknic``, the
flight recorder). ``python3 chip_smoke.py`` drives it on the card.
"""


def metrics_snapshot() -> dict:
    """One JSON-safe view of the always-on telemetry plane: the metrics
    registry (scheduler stage dwell/run percentiles, per-NIC wire bytes,
    retries, fault injections, train-step walltime, supervisor exits)
    plus the flight recorder's ring occupancy."""
    from byteps_tpu_torch.common.flight_recorder import get_flight_recorder
    from byteps_tpu_torch.common.metrics import get_registry

    return {
        "metrics": get_registry().snapshot(),
        "flight_recorder": get_flight_recorder().summary(),
    }
