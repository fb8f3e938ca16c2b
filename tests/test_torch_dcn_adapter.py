"""The port's torch adapter (``byteps_tpu_torch.torch``) against the
reference's (``byteps_tpu.torch``) in one job: worker 0 runs the
reference's adapter, worker 1 the port's, both on CPU tensors, over the
port's summation server. They train the reference example's ``Net`` with
``DistributedOptimizer(SGD)`` on seeded data of their own, and every
parameter is held bit for bit: across the two workers after each step,
and against a plain SGD step on the mean of the two workers' gradients.
Each adapter keeps module-global state, so each worker's calls run on a
thread of their own."""

import importlib.util
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import byteps_tpu.torch as rbps
import byteps_tpu_torch.torch as tbps
from byteps_tpu.common import config as rconfig
from byteps_tpu_torch import server as tserver
from byteps_tpu_torch.common import config as tconfig

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from dcn_fixtures import job_env, next_port  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "train_mnist_byteps", ROOT / "examples" / "pytorch" /
    "train_mnist_byteps.py")
_example = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_example)
Net = _example.Net

STEPS = 3
BATCH = 16
LR = 0.05


@pytest.fixture
def job(monkeypatch):
    """A port server and two initialized workers: the reference adapter as
    worker 0, the port's as worker 1. Yields ``run(fn0, fn1)``, which runs
    each worker's function on its own thread and returns their results."""
    torch.set_num_threads(1)
    port = tserver.any_port(
        lambda p: tserver.start_server(port=p, num_workers=2,
                                       engine_threads=2,
                                       pull_timeout_ms=20000), next_port())
    job_env(monkeypatch, port)
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    rconfig.reset_config()
    rconfig.get_config()
    monkeypatch.setenv("DMLC_WORKER_ID", "1")
    tconfig.reset_config()
    tconfig.get_config()

    def run(fn0, fn1, timeout=60):
        out, errors = {}, []

        def call(i, fn):
            # one intra-op thread in every thread (the setting is per
            # thread), so both workers and the plain step reduce alike
            torch.set_num_threads(1)
            try:
                out[i] = fn()
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append((i, repr(e)))

        ts = [threading.Thread(target=call, args=(i, fn))
              for i, fn in enumerate((fn0, fn1))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout)
        assert not any(t.is_alive() for t in ts), "a worker hung"
        assert not errors, errors
        return out[0], out[1]

    try:
        run(rbps.init, tbps.init)
        yield run
        run(rbps.shutdown, tbps.shutdown)
    finally:
        rbps._state.initialized = False
        tbps._state.initialized = False
        tserver.stop_server()
        rconfig.reset_config()
        tconfig.reset_config()


def _data(worker, passes=1):
    rng = np.random.default_rng(100 + worker)
    x = rng.standard_normal((STEPS, passes, BATCH, 1, 28, 28)).astype(
        np.float32)
    y = rng.integers(0, 10, (STEPS, passes, BATCH))
    return torch.from_numpy(x), torch.from_numpy(y)


def _model(seed=0):
    torch.manual_seed(seed)
    return Net()


def _snapshot(model):
    return [p.detach().clone() for p in model.parameters()]


def _train(bps, model, worker, passes=1, compression="none"):
    """STEPS steps of DistributedOptimizer(SGD) on this worker's data;
    the parameters after each step."""
    def fn():
        opt = bps.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9),
            named_parameters=model.named_parameters(),
            compression=compression, backward_passes_per_step=passes)
        x, y = _data(worker, passes)
        snaps = []
        for s in range(STEPS):
            opt.zero_grad()
            for k in range(passes):
                F.nll_loss(model(x[s, k]), y[s, k]).backward()
                opt.step()
            snaps.append(_snapshot(model))
        return snaps
    return fn


def _plain(passes=1):
    """SGD on the mean of the two workers' gradients, computed directly."""
    model = _model()
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9)
    data = [_data(w, passes) for w in range(2)]
    snaps = []
    for s in range(STEPS):
        grads = []
        for x, y in data:
            model.zero_grad()
            for k in range(passes):
                F.nll_loss(model(x[s, k]), y[s, k]).backward()
            grads.append([p.grad.clone() for p in model.parameters()])
        for p, g0, g1 in zip(model.parameters(), *grads):
            p.grad = (g0 + g1) / 2
        opt.step()
        snaps.append(_snapshot(model))
    return snaps


def _bits_equal(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


@pytest.mark.parametrize("passes", [1, 2])
def test_distributed_sgd_bit_equal_to_reference_and_plain(job, passes):
    ref, port = job(_train(rbps, _model(), 0, passes),
                    _train(tbps, _model(), 1, passes))
    plain = _plain(passes)
    for s in range(STEPS):
        assert _bits_equal(ref[s], port[s]), f"step {s}: workers differ"
        assert _bits_equal(port[s], plain[s]), f"step {s}: not plain SGD"
    assert not _bits_equal(port[0], _snapshot(_model()))


def test_fp16_wire_equal_across_workers(job):
    ref, port = job(_train(rbps, _model(), 0, compression="fp16"),
                    _train(tbps, _model(), 1, compression="fp16"))
    plain = _plain()
    for s in range(STEPS):
        assert _bits_equal(ref[s], port[s]), f"step {s}: workers differ"
        for a, b in zip(port[s], plain[s]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-3)
    # the fp16 wire is not the f32 one
    assert not all(_bits_equal(port[s], plain[s]) for s in range(STEPS))


def test_sum_and_broadcasts(job):
    rng = np.random.default_rng(5)
    xs = [torch.from_numpy(rng.standard_normal((33, 65)).astype(np.float32))
          for _ in range(2)]
    half = [torch.from_numpy(rng.standard_normal(1000).astype(np.float16))
            for _ in range(2)]

    models = [_model(seed=w) for w in range(2)]  # torch's RNG is global

    def work(bps, w):
        def fn():
            out = {"sum": bps.push_pull(xs[w].clone(), average=False,
                                        name="sum"),
                   "mean16": bps.push_pull(half[w].clone(), name="mean16")}
            model = models[w]
            bps.broadcast_parameters(dict(model.named_parameters()),
                                     root_rank=0)
            out["params"] = _snapshot(model)
            opt = torch.optim.SGD(model.parameters(), lr=LR + 0.01 * w,
                                  momentum=0.9)
            for i, p in enumerate(model.parameters()):
                opt.state[p]["momentum_buffer"] = torch.full_like(
                    p, float(w + i))
            bps.broadcast_optimizer_state(opt, root_rank=0)
            out["lr"] = opt.param_groups[0]["lr"]
            out["momentum"] = [opt.state[p]["momentum_buffer"].clone()
                               for p in model.parameters()]
            out["rank"], out["size"] = bps.rank(), bps.size()
            return out
        return fn

    ref, port = job(work(rbps, 0), work(tbps, 1))
    assert (ref["rank"], port["rank"], ref["size"], port["size"]) == \
        (0, 1, 2, 2)
    for out in (ref, port):
        assert torch.equal(out["sum"], xs[0] + xs[1])
        assert out["mean16"].dtype == torch.float16
        assert _bits_equal(out["params"], _snapshot(_model(seed=0)))
        assert all(torch.equal(m, torch.full_like(m, float(i)))
                   for i, m in enumerate(out["momentum"]))
    assert torch.equal(ref["mean16"], port["mean16"])
    assert torch.equal(port["mean16"], ((half[0].float() + half[1].float())
                                        / 2).half())
    assert ref["lr"] == port["lr"] == float(np.float32(LR))


def test_requires_init_and_a_name():
    with pytest.raises(RuntimeError, match="init"):
        tbps.size()
    tbps._state.initialized = True
    try:
        with pytest.raises(RuntimeError, match="tensor name"):
            tbps.push_pull_async(torch.zeros(3))
    finally:
        tbps._state.initialized = False


def test_dcn_trainer_equals_staged_step_on_cpu(tmp_path):
    """The card smoke's train_dcn on the CPU at a tiny width: two rank
    processes train a tiny GPT with the staged all-reduce step, then with
    the port's DistributedOptimizer over a server process. dcn_raw's
    parameters equal staged_raw's after every step, bit for bit (two
    workers: a + b is exact in either order and /2 is exact); both ranks
    agree on every leg; the bytes on the wire are the partitions' codec
    bytes; the server exits 0 once both ranks said goodbye."""
    import json
    import os
    import subprocess

    port = tserver.any_port(_free, next_port())
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="",
               DMLC_ROLE="server", DMLC_NUM_WORKER="2", DMLC_NUM_SERVER="1",
               DMLC_PS_ROOT_URI="127.0.0.1", DMLC_PS_ROOT_PORT=str(port - 1))
    helper = ROOT / "tests" / "helpers" / "dcn_gpt_rank.py"
    server = subprocess.Popen([sys.executable, "-m",
                               "byteps_tpu_torch.server"], env=env, cwd=ROOT)
    ranks = [subprocess.Popen([sys.executable, str(helper), str(r),
                               str(port), str(tmp_path / "store"),
                               str(tmp_path / f"rank{r}.json"), "3"],
                              env=env, cwd=ROOT, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        errs = [p.communicate(timeout=120)[1] for p in ranks]
        assert [p.returncode for p in ranks] == [0, 0], errs
        assert server.wait(timeout=30) == 0
    finally:
        for p in ranks + [server]:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(2)]
    for leg in ("staged_raw", "dcn_raw", "dcn_fp16"):
        assert res[0][leg]["digests"] == res[1][leg]["digests"], leg
    for r in res:
        assert r["dcn_raw"]["digests"] == r["staged_raw"]["digests"]
        assert r["dcn_fp16"]["digests"] != r["dcn_raw"]["digests"]
        raw = r["n_params"] * 4
        assert all(b == [raw, raw] for b in r["dcn_raw"]["bytes"])
        # the tiny model's partitions all lie under min_compress_bytes but
        # the embedding's: fp16 moves fewer bytes than raw, never more
        assert all(b[0] == b[1] and b[0] < raw for b in
                   r["dcn_fp16"]["bytes"])
        np.testing.assert_allclose(r["dcn_fp16"]["losses"],
                                   r["dcn_raw"]["losses"], atol=1e-2)


def _free(p):
    """Bind probe for any_port: the port is free to listen on."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", p))
    return p


def test_dropped_optimizer_frees_its_parameters(monkeypatch):
    """The optimizer's gradient hooks live on the parameters, whose hooks
    the garbage collector does not traverse: they must not keep the
    optimizer, and with it the parameters and their state, alive once the
    caller drops both."""
    import gc
    import weakref

    torch.set_num_threads(1)
    port = tserver.any_port(
        lambda p: tserver.start_server(port=p, num_workers=1,
                                       engine_threads=2), next_port())
    job_env(monkeypatch, port, workers=1)
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    tconfig.reset_config()
    try:
        tbps.init()
        net = torch.nn.Linear(8, 4)
        alive = weakref.ref(net.weight)
        opt = tbps.DistributedOptimizer(
            torch.optim.SGD(net.parameters(), lr=LR), net.named_parameters())
        net(torch.ones(2, 8)).sum().backward()
        opt.step()
        del net, opt
        gc.collect()
        assert alive() is None
    finally:
        tbps.shutdown()
        tserver.stop_server()
        tconfig.reset_config()
