"""The port's boundary and plumbing: ``byteps_tpu_torch`` imports no
JAX, nothing of ``byteps_tpu`` and no ``transformers``; its entry points
run on CUDA unless told otherwise; CPU tensors never reach the kernel
build; the lean config and metrics copies behave like the reference's."""

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
                if m.split(".")[0] in ("jax", "byteps_tpu", "transformers"))
from byteps_tpu_torch.models import (GPTConfig, gpt_init, make_eval_step,
                                     make_generate_fn, make_gpt_train_step,
                                     params_from_numpy)
from byteps_tpu_torch.models.generate import init_cache
from byteps_tpu_torch.parallel.zero3 import make_gpt_zero3_train_step
from byteps_tpu_torch.serve import AdapterPool, PagedKVCache, Scheduler
from byteps_tpu_torch.models import adapters_from_numpy
from byteps_tpu_torch.models.lora import lora_init
from byteps_tpu_torch.models import (BertConfig, ResNetConfig, T5Config,
                                     ViTConfig, bert_init,
                                     make_bert_train_step,
                                     make_resnet_train_step,
                                     make_t5_generate_fn, make_t5_train_step,
                                     make_vit_train_step, resnet_init, t5_init,
                                     tree_from_numpy, vit_init)
from byteps_tpu_torch.models.t5 import t5_init_cache
from byteps_tpu_torch.models.convert import tree_to_numpy
cfg = GPTConfig.tiny()
bert_tree = tree_to_numpy(bert_init(BertConfig.tiny(), device="cpu"))
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
    "make_eval_step": lambda: make_eval_step(cfg),
    "make_gpt_zero3_train_step": lambda: make_gpt_zero3_train_step(cfg),
    "AdapterPool": lambda: AdapterPool(cfg, n_slots=2, rank_bucket=2),
    "lora_init": lambda: lora_init(cfg, 2),
    "adapters_from_numpy": lambda: adapters_from_numpy(
        {"blocks": [{"wq": {"a": np.zeros((64, 2), np.float32),
                            "b": np.zeros((2, 64), np.float32)}}]}),
    "bert_init": lambda: bert_init(BertConfig.tiny()),
    "vit_init": lambda: vit_init(ViTConfig.tiny()),
    "t5_init": lambda: t5_init(T5Config.tiny()),
    "resnet_init": lambda: resnet_init(ResNetConfig.tiny()),
    "tree_from_numpy": lambda: tree_from_numpy(bert_tree, BertConfig.tiny()),
    "make_bert_train_step": lambda: make_bert_train_step(BertConfig.tiny()),
    "make_vit_train_step": lambda: make_vit_train_step(ViTConfig.tiny()),
    "make_t5_train_step": lambda: make_t5_train_step(T5Config.tiny()),
    "make_resnet_train_step": lambda: make_resnet_train_step(
        ResNetConfig.tiny()),
    "make_t5_generate_fn": lambda: make_t5_generate_fn(T5Config.tiny(), 4),
    "t5_init_cache": lambda: t5_init_cache(T5Config.tiny(), 1),
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
              "eager", "parallel.mesh", "parallel.partitioner",
              "parallel.sharding", "parallel.tp", "parallel.ring_attention",
              "parallel.remat", "parallel.pipeline", "parallel.moe",
              "parallel.zero3", "models.moe_gpt", "models.bert",
              "models.vit", "models.t5", "models.resnet",
              "models.import_hf", "launcher", "_boot", "checkpoint",
              "comm.distributed", "comm.mesh", "data", "data.loader",
              "data.elastic", "common.socknic", "serve.kv_socket",
              "common.flight_recorder", "common.autoscaler"):
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


def test_family_modules_import_alone_without_jax():
    """The model families, their train factories and the HuggingFace
    bridge, imported on their own, load neither jax, nor byteps_tpu, nor
    transformers."""
    probe = ("import sys\n"
             "import byteps_tpu_torch.models.bert\n"
             "import byteps_tpu_torch.models.vit\n"
             "import byteps_tpu_torch.models.t5\n"
             "import byteps_tpu_torch.models.resnet\n"
             "import byteps_tpu_torch.models.import_hf\n"
             "import byteps_tpu_torch.models.train\n"
             "print([m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'byteps_tpu', 'transformers')])")
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_process_tier_modules_import_alone_without_jax():
    """The launcher, the bootstrap, the global group, the mesh helpers,
    the checkpointer, the input pipeline, the socket NIC and the KV
    socket, imported on their own, load neither jax nor byteps_tpu; the
    launcher, the socket NIC and the checkpointer load no torch either,
    nor does a checkpoint of numpy state (a supervised child starts
    and checkpoints without it)."""
    probe = ("import sys, tempfile\n"
             "import numpy as np\n"
             "import byteps_tpu_torch.launcher, byteps_tpu_torch._boot\n"
             "import byteps_tpu_torch.common.socknic\n"
             "from byteps_tpu_torch.checkpoint import Checkpointer\n"
             "ck = Checkpointer(tempfile.mkdtemp(), async_save=False)\n"
             "ck.save(0, {'state': np.ones(3, np.float32), 'round': 0})\n"
             "r = ck.restore({'state': np.zeros(3, np.float32), "
             "'round': 1})\n"
             "assert r['round'] == 0 and r['state'].sum() == 3\n"
             "torch_free = 'torch' not in sys.modules\n"
             "import byteps_tpu_torch.comm.distributed\n"
             "import byteps_tpu_torch.comm.mesh\n"
             "import byteps_tpu_torch.checkpoint\n"
             "import byteps_tpu_torch.data\n"
             "import byteps_tpu_torch.serve.kv_socket\n"
             "print(torch_free, [m for m in sys.modules if m.split('.')[0] "
             "in ('jax', 'byteps_tpu')])")
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True []", out.stdout


def test_parallel_modules_import_alone_without_jax():
    """The mesh, the partitioner, the sharding specs, tensor parallelism,
    ring attention, the pipeline, the MoE FFN, ZeRO-3 and the MoE GPT,
    imported on their own, load neither jax nor byteps_tpu."""
    probe = ("import sys\n"
             "import byteps_tpu_torch.parallel.mesh\n"
             "import byteps_tpu_torch.parallel.partitioner\n"
             "import byteps_tpu_torch.parallel.sharding\n"
             "import byteps_tpu_torch.parallel.tp\n"
             "import byteps_tpu_torch.parallel.ring_attention\n"
             "import byteps_tpu_torch.parallel.pipeline\n"
             "import byteps_tpu_torch.parallel.moe\n"
             "import byteps_tpu_torch.parallel.zero3\n"
             "import byteps_tpu_torch.models.moe_gpt\n"
             "print([m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'byteps_tpu')])")
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("family,axes,rank", [
    ("gpt", {"pp": 2}, 1), ("gpt", {"pp": 2, "tp": 2}, 2),
    ("moe", {"pp": 2, "ep": 2}, 3)])
def test_stage_leaf_order_is_the_reference_stacked_pytree(family, axes,
                                                          rank):
    """A pp stage's slab (``params_from_numpy(..., stacked=True)``) lists
    its leaves in ``jax.tree.flatten`` order of the reference's stacked
    tree (``stack_blocks``, the tree its pp factories train), each leaf
    the reference's stage slice (and tp or ep shard): the order the
    ``DistributedOptimizer``'s chunks, and so every onebit scale,
    follow."""
    import jax

    from byteps_tpu.models.gpt import GPTConfig as JConfig
    from byteps_tpu.models.gpt import gpt_init as j_init
    from byteps_tpu.models.moe_gpt import MoEGPTConfig as JMoEConfig
    from byteps_tpu.models.moe_gpt import moe_gpt_init as j_moe_init
    from byteps_tpu.parallel.pipeline import stack_blocks as j_stack
    from byteps_tpu_torch.models import (GPTConfig, MoEGPTConfig,
                                         flat_leaves, params_from_numpy)
    from byteps_tpu_torch.models.convert import (flat_specs, param_specs,
                                                 shard_leaf)

    sys.path.insert(0, str(ROOT / "tests" / "helpers"))
    from pp_moe_parity import fake_mesh

    if family == "gpt":
        jcfg = JConfig(**{**JConfig.tiny().__dict__, "n_layers": 4})
        cfg = GPTConfig(**{**GPTConfig.tiny().__dict__, "n_layers": 4})
        raw = j_init(jax.random.PRNGKey(0), jcfg)
    else:
        jcfg = JMoEConfig(**{**JMoEConfig.tiny().__dict__, "n_layers": 4})
        cfg = MoEGPTConfig(**{**MoEGPTConfig.tiny().__dict__,
                              "n_layers": 4})
        raw = j_moe_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, raw)
    mesh = fake_mesh(axes, rank)
    got = flat_leaves(params_from_numpy(tree, cfg, device="cpu", mesh=mesh,
                                        stacked=True))
    ref = {k: v for k, v in tree.items() if k != "blocks"}
    ref["blocks"] = j_stack(tree["blocks"])
    want = [np.asarray(a) for a in jax.tree.leaves(ref)]
    specs = flat_specs(param_specs(cfg, mesh, stacked=True))
    assert len(got) == len(want) == len(specs)
    for t, a, spec in zip(got, want, specs):
        np.testing.assert_array_equal(t.numpy(), shard_leaf(a, spec, mesh))
    assert specs[0][0] == "pp"


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


_EXAMPLES_PROBE = r"""
import json, os, runpy, sys
from byteps_tpu_torch import server
from byteps_tpu_torch.common.config import reset_config
port = int(sys.argv[1])
for script, args in (
        ("train_mnist_byteps.py", ["--device", "cpu", "--epochs", "1",
                                   "--samples", "64"]),
        ("benchmark_byteps.py", ["--device", "cpu", "--num-iters", "1",
                                 "--tensor-mb", "0.1"])):
    port = server.start_server_any_port(port, num_workers=1,
                                        engine_threads=1)
    os.environ["DMLC_PS_ROOT_PORT"] = str(port - 1)
    reset_config()
    path = os.path.join("examples", "torch_port", script)
    sys.argv = [path, *args]
    runpy.run_path(path, run_name="__main__")
    server.stop_server()
    port += 20
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "byteps_tpu"))))
"""


def test_examples_run_without_jax():
    """The port's two examples, run to their end in one process (one
    worker, a port server in the process), load neither jax nor
    byteps_tpu."""
    sys.path.insert(0, str(ROOT / "tests" / "helpers"))
    from dcn_fixtures import next_port, port_lib

    port_lib()
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="",
               DMLC_NUM_WORKER="1", DMLC_NUM_SERVER="1",
               DMLC_PS_ROOT_URI="127.0.0.1", DMLC_WORKER_ID="0",
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _EXAMPLES_PROBE,
                          str(next_port())], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "epoch 0: loss=" in out.stdout and "push_pull:" in out.stdout
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


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
