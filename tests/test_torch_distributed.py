"""The global ``torch.distributed`` group from the ``DMLC_*`` environment
(``byteps_tpu_torch/comm/distributed.py``), twin of
``tests/test_jax_distributed.py``: two worker processes form one gloo
group (worker 0 hosts the TCP store), a step of the port's train factory
aggregates over it and both land on the same parameters — once with the
worker ids given, once through the launcher alone, which interposes the
bootstrap (``byteps_tpu_torch._boot``) and runs
``examples/torch_port/checkpoint_resume.py`` unchanged.

Every process here carries a hard timeout.
"""

import os
import re
import socket
import subprocess
import sys

import pytest

from byteps_tpu_torch.comm import distributed as tdist
from byteps_tpu_torch.common.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_T = 240

# one rank: join the group (twice: the second is a no-op), a mesh over it,
# one raw GPT step, then the parameters' digest
_RANK = r"""
import hashlib, sys, torch
torch.set_num_threads(1)
from byteps_tpu_torch.comm.distributed import (is_multiprocess,
                                               maybe_init_distributed)
from byteps_tpu_torch.comm.mesh import device_mesh
assert maybe_init_distributed() and maybe_init_distributed()
import torch.distributed as dist
rank = dist.get_rank()
mesh = device_mesh()
assert mesh.shape["dp"] == dist.get_world_size() == 2 and is_multiprocess()
from byteps_tpu_torch.models import GPTConfig, make_gpt_train_step
from byteps_tpu_torch.models.convert import flat_leaves
cfg = GPTConfig.tiny()
step, params, opt = make_gpt_train_step(
    cfg, device="cpu", generator=torch.Generator().manual_seed(0))
g = torch.Generator().manual_seed(1 + rank)
toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=g)
loss = float(step(toks[:, :-1], toks[:, 1:]))
h = hashlib.sha1()
for p in flat_leaves(params):
    h.update(p.detach().numpy().tobytes())
print(f"JD_OK rank={rank} loss={loss} digest={h.hexdigest()}", flush=True)
dist.destroy_process_group()
print(f"JD_DONE rank={rank}", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(port, wid=None):
    env = dict(os.environ)
    env.update({"PYTHONPATH": REPO, "DMLC_ROLE": "worker",
                "DMLC_NUM_WORKER": "2", "DMLC_PS_ROOT_URI": "127.0.0.1",
                "DMLC_PS_ROOT_PORT": str(port),
                "BYTEPS_JAX_DISTRIBUTED": "1"})
    env.pop("DMLC_WORKER_ID", None)
    env.pop("BYTEPS_LOCAL_SIZE", None)
    if wid is not None:
        env["DMLC_WORKER_ID"] = str(wid)
    return env


def test_two_process_global_group():
    """Two workers join one gloo group from the DMLC_* environment; the
    aggregated step lands both on identical parameters."""
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", _RANK],
                              env=_env(port, i), cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=_T)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i}:\n{outs[i]}"
        assert f"JD_DONE rank={i}" in outs[i], outs[i]
    ok = [re.search(r"JD_OK rank=\d loss=(\S+) digest=(\w+)", o).groups()
          for o in outs]
    assert ok[0] == ok[1], ok   # the group's mean loss, the same params


def test_launcher_brings_up_global_group(tmp_path):
    """The launcher alone (no worker ids, no change to the script) spawns
    both workers, interposes the bootstrap, and the group forms before
    the example runs: both report the restored checkpoint matching and
    equal digests."""
    env = _env(_free_port())
    env.update({"DMLC_WORKER_ID": "0", "BYTEPS_LOCAL_SIZE": "2",
                "TMPDIR": str(tmp_path)})
    p = subprocess.run(
        [sys.executable, "-m", "byteps_tpu_torch.launcher", sys.executable,
         os.path.join(REPO, "examples", "torch_port", "checkpoint_resume.py"),
         "--device", "cpu", "--steps", "3", "--print-digest"],
        env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=_T)
    assert p.returncode == 0, p.stdout
    digests = {}
    for i in range(2):
        assert (f"[worker {i}] restored checkpoint matches live params: "
                "True") in p.stdout, p.stdout
        digests[i] = re.search(rf"\[worker {i}\] params sha1=(\w+)",
                               p.stdout).group(1)
    assert digests[0] == digests[1]
    # the launcher's log (stderr, merged here) names the interposition
    assert "-m byteps_tpu_torch._boot" in p.stdout


@pytest.mark.parametrize("env", [
    {"DMLC_NUM_WORKER": "2"},                          # no switch
    {"BYTEPS_JAX_DISTRIBUTED": "1"},                   # one worker
    {"BYTEPS_JAX_DISTRIBUTED": "1", "DMLC_NUM_WORKER": "1"},
])
def test_no_group_unless_asked_for_several_workers(monkeypatch, env):
    """A single worker, or no switch, forms no group — and the global
    group turns the hybrid pipeline off (``is_distributed``) as the
    reference's global mesh does."""
    for k in ("BYTEPS_JAX_DISTRIBUTED", "DMLC_NUM_WORKER"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = Config.from_env()
    assert tdist.maybe_init_distributed(cfg) is False
    assert tdist.is_multiprocess() is False
    both = Config(num_worker=2, global_group=True)
    assert both.is_distributed is False
    assert Config(num_worker=2).is_distributed is True
    assert Config(num_worker=2, global_group=True,
                  force_distributed=True).is_distributed is True
