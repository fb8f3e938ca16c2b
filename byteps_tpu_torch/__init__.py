"""byteps_tpu_torch — the PyTorch/CUDA port of ``byteps_tpu``.

A package of its own beside the JAX reference: it imports ``torch``
and never ``jax`` or any module of ``byteps_tpu``. Every Pallas kernel
on a ported path becomes a kernel written by hand for Hopper
(``ops/csrc``), built with ``nvcc`` at first use; beside each kernel
sits its plain PyTorch version, which CPU tensors take. Entry points
run on the card unless the caller passes ``device="cpu"``.

Ported so far: serving (``serve.Scheduler`` over the paged KV cache,
multi-tenant LoRA through ``serve.AdapterPool``,
``models.generate.make_generate_fn``) and data-parallel training
(``models.make_gpt_train_step``, every codec of ``compression``, the
staged and ring wire tiers of ``comm.ici``), on thirteen hand-written
kernels. ``python3 chip_smoke.py`` drives it on the card.
"""
