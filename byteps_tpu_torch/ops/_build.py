"""Build the hand-written CUDA kernels at first use; load them with ctypes.

Each ``csrc/<name>.cu`` holds one kernel behind an ``extern "C"``
launcher that takes raw device pointers, sizes, runtime offsets as ints
and a ``cudaStream_t``, and returns ``cudaGetLastError()``. It includes
no PyTorch header, so ``nvcc`` builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o lib<name>-<digest>.so csrc/<name>.cu

(plus ``-Xptxas -v``, whose register and shared-memory report is kept
beside the library as ``.log``). The library lands in ``_build/``
(git-ignored), named by a digest of its sources and flags, so an edited
source is rebuilt and an unchanged one is built once per checkout.
:func:`build` starts one ``nvcc`` per missing library, all together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("flash_fwd", "flash_decode", "flash_bwd", "onebit", "topk",
           "segmented_lora", "ring")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location."""
    cands = [Path(os.environ[v]) / "bin" / "nvcc"
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of byteps_tpu_torch are built from source at first use")


def library_path(name: str) -> Path:
    """Where ``name``'s library lives, keyed by its sources and flags."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(name: str, out: Path) -> list:
    return [find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every library of ``names`` that is missing, one ``nvcc``
    each, all started together; raise with the compiler's output if any
    fails. Returns ``{name: library path}``."""
    names = tuple(names)
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            procs[name] = (subprocess.Popen(
                nvcc_command(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), tmp, out)
        errors = []
        for name, (proc, tmp, out) in procs.items():
            text, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"--- {name} (nvcc exit {proc.returncode})\n"
                              f"{text}")
                continue
            out.with_suffix(".log").write_text(text)
            os.replace(tmp, out)      # atomic: readers see all or nothing
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return {name: library_path(name) for name in names}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing.
    Each op module declares its launcher's ``argtypes``/``restype``."""
    return ctypes.CDLL(str(build((name,))[name]))


def error_string(lib: ctypes.CDLL, code: int) -> str:
    """``cudaGetErrorString`` through the library's own runtime."""
    lib.bps_error_string.argtypes = [ctypes.c_int]
    lib.bps_error_string.restype = ctypes.c_char_p
    return lib.bps_error_string(code).decode()
