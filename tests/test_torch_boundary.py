"""The port's boundary and plumbing: ``byteps_tpu_torch`` imports no JAX
and nothing of ``byteps_tpu``; its entry points run on CUDA unless told
otherwise; CPU tensors never reach the kernel build; the lean config and
metrics copies behave like the reference's."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from byteps_tpu_torch.common import config as tconfig
from byteps_tpu_torch.common import metrics as tmetrics
from byteps_tpu_torch.ops import _build

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, subprocess, sys
import numpy as np
import byteps_tpu_torch
mods = sorted(m.name for m in pkgutil.walk_packages(
    byteps_tpu_torch.__path__, "byteps_tpu_torch."))
popen = subprocess.Popen
started = []
subprocess.Popen = lambda *a, **k: started.append(a) or popen(*a, **k)
for m in mods:
    importlib.import_module(m)
subprocess.Popen = popen
from byteps_tpu_torch.server import native
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "byteps_tpu"
                or m.startswith("byteps_tpu."))
from byteps_tpu_torch.models import (GPTConfig, gpt_init, make_generate_fn,
                                     make_gpt_train_step, params_from_numpy)
from byteps_tpu_torch.models.generate import init_cache
from byteps_tpu_torch.serve import AdapterPool, PagedKVCache, Scheduler
from byteps_tpu_torch.models import adapters_from_numpy
from byteps_tpu_torch.models.lora import lora_init
cfg = GPTConfig.tiny()
cpu = gpt_init(cfg, device="cpu")
tree = {k: v.numpy() for k, v in cpu.named_parameters() if "." not in k}
tree["blocks"] = [{k: v.numpy() for k, v in b.named_parameters()}
                  for b in cpu.blocks]
calls = {
    "gpt_init": lambda: gpt_init(cfg),
    "params_from_numpy": lambda: params_from_numpy(tree, cfg),
    "make_generate_fn": lambda: make_generate_fn(cfg, 4),
    "init_cache": lambda: init_cache(cfg, 1),
    "PagedKVCache": lambda: PagedKVCache(cfg, block_size=4, pool_blocks=8,
                                         max_batch=1),
    "Scheduler": lambda: Scheduler(cpu, cfg),
    "make_gpt_train_step": lambda: make_gpt_train_step(cfg),
    "AdapterPool": lambda: AdapterPool(cfg, n_slots=2, rank_bucket=2),
    "lora_init": lambda: lora_init(cfg, 2),
    "adapters_from_numpy": lambda: adapters_from_numpy(
        {"blocks": [{"wq": {"a": np.zeros((64, 2), np.float32),
                            "b": np.zeros((2, 64), np.float32)}}]}),
}
raised = {}
for name, fn in calls.items():
    try:
        fn()
        raised[name] = None
    except RuntimeError as e:
        raised[name] = str(e)
print(json.dumps({"modules": mods, "leaked": leaked, "raised": raised,
                  "import_processes": len(started),
                  "server_lib_loaded": native._lib is not None}))
"""


def test_port_imports_no_jax_and_entry_points_default_to_cuda():
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "byteps_tpu_torch.serve.scheduler" in res["modules"]
    assert "byteps_tpu_torch.serve.adapter_pool" in res["modules"]
    assert "byteps_tpu_torch.ops.segmented_lora" in res["modules"]
    assert "byteps_tpu_torch.ops._build" in res["modules"]
    assert "byteps_tpu_torch.ops.ring_collective_kernels" in res["modules"]
    for m in ("common.dcn_adapter", "common.faults", "common.partition",
              "common.scheduler", "common.stage_orders", "compression.wire",
              "server",
              "server.__main__", "server.native", "server.pacer", "torch",
              "eager"):
        assert f"byteps_tpu_torch.{m}" in res["modules"], m
    assert res["leaked"] == [], res["leaked"]
    # importing every module (the server entry included) built, loaded and
    # started nothing
    assert res["import_processes"] == 0
    assert res["server_lib_loaded"] is False
    for name, msg in res["raised"].items():
        assert msg is not None and "device='cpu'" in msg, (name, msg)


def test_ring_modules_import_alone_without_jax():
    """The ring transport and the ICI tier that calls it, imported on
    their own, load neither jax nor byteps_tpu."""
    probe = ("import sys\n"
             "import byteps_tpu_torch.ops.ring_collective_kernels\n"
             "import byteps_tpu_torch.comm.ici\n"
             "print([m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'byteps_tpu')])")
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_dcn_modules_import_alone_without_jax():
    """The DCN tier, the torch adapter and the eager surface, imported on
    their own, load neither jax nor byteps_tpu, and leave the server
    library unbuilt and unloaded (the first server or connection builds
    it)."""
    probe = ("import sys\n"
             "import byteps_tpu_torch.torch\n"
             "import byteps_tpu_torch.eager\n"
             "import byteps_tpu_torch.server.__main__\n"
             "from byteps_tpu_torch.server import native\n"
             "print([m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'byteps_tpu')], native._lib)")
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] None", out.stdout


def test_cpu_tensors_never_touch_the_kernel_build(monkeypatch):
    from byteps_tpu_torch.models import GPTConfig, make_gpt_train_step
    from byteps_tpu_torch.ops.flash_attention import flash_attention_lse
    from byteps_tpu_torch.ops.flash_decode import flash_decode
    from byteps_tpu_torch.ops.onebit_kernels import (onebit_pack,
                                                     onebit_unpack,
                                                     onebit_unpack_sum)

    def refuse(name):
        raise AssertionError(f"CPU call tried to load kernel {name}")

    monkeypatch.setattr(_build, "load", refuse)
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.standard_normal((1, 8, 2, 16), np.float32))
    o, lse = flash_attention_lse(q, q, q, 0, 0)
    assert o.shape == q.shape and lse.shape == (1, 8, 2)
    k = torch.as_tensor(rng.standard_normal((1, 8, 2, 16), np.float32))
    assert flash_decode(q[:, :1], k, k, 5).shape == (1, 1, 2, 16)
    # the backward Function
    qg = q.clone().requires_grad_()
    o, lse = flash_attention_lse(qg, k, k, 0, 0)
    (o.sum() + lse.sum()).backward()
    assert qg.grad.shape == q.shape
    # the onebit ops
    x = torch.as_tensor(rng.standard_normal(1000, np.float32))
    words = onebit_pack(x)
    assert onebit_unpack(words, torch.ones(1), 1000).shape == (1000,)
    assert onebit_unpack_sum(torch.stack([words, words]), torch.ones(2),
                             1000).shape == (1000,)
    # the top-k ops
    from byteps_tpu_torch.ops.topk_kernels import (block_reconstruct_sum,
                                                   block_roundtrip,
                                                   block_select)
    lo, va = block_select(x[:990].reshape(10, 99), 985)
    assert block_reconstruct_sum(lo[None], va[None], 10).shape == (10, 99)
    d, r = block_roundtrip(x[:512], 2, 2, e=x[:512])
    assert torch.equal(d + r, x[:512] + x[:512])
    # and the whole training step, onebit or top-k with error feedback
    tok = torch.as_tensor(rng.integers(0, 256, (2, 9)))
    for comp in ({"compressor": "onebit", "ef": "vanilla"},
                 {"compressor": "topk", "k": 0.01, "ef": "vanilla",
                  "selection": "block"}):
        step, _, _ = make_gpt_train_step(
            GPTConfig.tiny(), compression_params=comp,
            generator=torch.Generator().manual_seed(0), device="cpu")
        assert torch.isfinite(step(tok[:, :-1], tok[:, 1:]))


def test_nvcc_command_and_library_name():
    out = _build.BUILD_DIR / "libx.so"
    try:
        cmd = _build.nvcc_command("flash_fwd", out)
    except RuntimeError as e:            # no nvcc on this machine
        assert "nvcc not found" in str(e)
        cmd = ["nvcc", *_build.NVCC_FLAGS, "-o", str(out),
               str(_build.CSRC / "flash_fwd.cu")]
    flags = " ".join(cmd)
    assert "-gencode arch=compute_90a,code=sm_90a" in flags
    for f in ("-std=c++17", "-O3", "-shared", "-Xcompiler -fPIC"):
        assert f in flags
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").is_file()
        p = _build.library_path(name)
        assert p.parent == _build.BUILD_DIR and p.name.startswith(f"lib{name}-")


_FAKE_NVCC = """#!{python}
import pathlib, sys
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
if {fail}:
    sys.exit("fake nvcc: error in " + args[-1])
pathlib.Path(args[args.index("-o") + 1]).write_text("lib")
print("ptxas info    : Used 1 registers")
"""


def _fake_toolkit(tmp_path, monkeypatch, fail=False):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    log = tmp_path / "nvcc.log"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable, log=str(log),
                                      fail=fail))
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return log


def test_build_compiles_each_kernel_once(monkeypatch, tmp_path):
    log = _fake_toolkit(tmp_path, monkeypatch)
    libs = _build.build()
    assert sorted(libs) == sorted(_build.KERNELS)
    for name, path in libs.items():
        assert path.read_text() == "lib"
        assert "registers" in path.with_suffix(".log").read_text()
    calls = log.read_text().splitlines()
    assert len(calls) == len(_build.KERNELS)
    assert all("-gencode arch=compute_90a,code=sm_90a" in c for c in calls)
    _build.build()                       # present and current: no rebuild
    assert len(log.read_text().splitlines()) == len(_build.KERNELS)
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_build_failure_raises_with_compiler_output(monkeypatch, tmp_path):
    _fake_toolkit(tmp_path, monkeypatch, fail=True)
    with pytest.raises(RuntimeError, match="fake nvcc: error in"):
        _build.build(("flash_decode",))
    assert not list((tmp_path / "build").iterdir())


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """No card: the smoke exits non-zero and prints no result — in the
    repo and alone in a directory without the package."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("a system CUDA toolkit is installed")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_config_env_parsing(monkeypatch):
    monkeypatch.setenv("BYTEPS_SERVE_BLOCK_SIZE", "8")
    monkeypatch.setenv("BYTEPS_SERVE_PREFIX_CACHE", "0")
    monkeypatch.setenv("BYTEPS_SERVE_QUANT_CACHE", "yes")
    monkeypatch.setenv("BYTEPS_SERVE_MAX_BATCH", "")
    tconfig.reset_config()
    try:
        c = tconfig.get_config()
        assert c.serve_block_size == 8
        assert c.serve_prefix_cache is False
        assert c.serve_quant_cache is True
        assert c.serve_max_batch == 8 and c.serve_prefill_chunk == 32
        assert c.serve_pool_blocks == 0
    finally:
        tconfig.reset_config()


def test_metrics_registry_and_json_safe(monkeypatch):
    reg = tmetrics.MetricsRegistry()
    reg.counter("serve.admitted").inc(3)
    reg.gauge("serve.r0.queue_depth").set(5)
    reg.gauge("serve.r0.queue_depth").set(2)
    h = reg.histogram("serve.ttft_ms")
    for v in (1.0, 3.0, 40.0):
        h.observe(v)
    snap = reg.snapshot("serve.")
    assert snap["counters"] == {"serve.admitted": 3}
    assert snap["gauges"]["serve.r0.queue_depth"] == {"value": 2, "max": 5}
    hs = snap["histograms"]["serve.ttft_ms"]
    assert hs["count"] == 3 and hs["min"] == 1.0 and hs["max"] == 40.0
    assert 1.0 <= hs["p50"] <= 5.0
    assert tmetrics.json_safe({"a": np.int64(2), "b": np.float32(np.inf),
                               "c": np.arange(3)}) == \
        {"a": 2, "b": "inf", "c": [0, 1, 2]}
    monkeypatch.setenv("BYTEPS_METRICS_ON", "0")
    tconfig.reset_config()
    tmetrics.reset_registry()
    try:
        off = tmetrics.get_registry()
        off.counter("x").inc()
        assert off.snapshot()["counters"] == {}
    finally:
        tconfig.reset_config()
        tmetrics.reset_registry()
