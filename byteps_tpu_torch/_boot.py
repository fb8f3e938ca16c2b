"""Worker bootstrap: join the global ``torch.distributed`` group BEFORE
user code runs (the port's counterpart of ``byteps_tpu/_jd_boot.py``).

With a global-group job (``BYTEPS_JAX_DISTRIBUTED=1``) the rendezvous
must precede the user script, as ps-lite's rendezvous precedes all CUDA
work in the reference's ``byteps_init()``, so ``python -m
byteps_tpu_torch.launcher`` interposes this module around the user
command::

    python -m byteps_tpu_torch._boot train.py args...

User scripts need no changes: ``sys.argv`` is rewritten so the script
sees exactly the argv it was launched with.
"""

from __future__ import annotations

import runpy
import sys


def main() -> int:
    from byteps_tpu_torch.comm.distributed import maybe_init_distributed

    if len(sys.argv) < 2:
        print("usage: python -m byteps_tpu_torch._boot script.py [args...]",
              file=sys.stderr)
        return 2
    maybe_init_distributed()
    sys.argv = sys.argv[1:]
    runpy.run_path(sys.argv[0], run_name="__main__")
    return 0


if __name__ == "__main__":
    sys.exit(main())
