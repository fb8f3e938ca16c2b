"""The port's copies of the PyTorch examples (``examples/torch_port/``)
run over one summation server and one process a worker (the processes
the launcher's server and worker roles start), configured by
``DMLC_*``, on the CPU.

* The MNIST example, two workers over the port's server (``python -m
  byteps_tpu_torch.server``), one epoch over 256 samples: each worker's
  per-epoch ``loss=… acc=…`` line equals, as a string, the line of
  ``examples/pytorch/train_mnist_byteps.py`` run the same way over the
  reference's server; both workers end with the same parameters.
* The benchmark example, ``--num-iters 2 --tensor-mb 1``, one worker and
  the port's server: it prints its GB/s line.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from dcn_fixtures import next_port, port_lib, reference_lib  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples" / "torch_port"
MNIST_ARGS = ["--epochs", "1", "--samples", "256", "--batch-size", "32"]
EPOCH_LINE = re.compile(r"^\[worker \d\] epoch \d+: loss=\S+ acc=\S+$")


def _env(port: int, workers: int, wid: int = 0) -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="",
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                DMLC_NUM_WORKER=str(workers), DMLC_NUM_SERVER="1",
                DMLC_PS_ROOT_URI="127.0.0.1",
                DMLC_PS_ROOT_PORT=str(port - 1), DMLC_WORKER_ID=str(wid))


def _workers(script: Path, args: list, port: int, workers: int,
             timeout: int = 180) -> list:
    """Run ``workers`` worker processes of ``script``; their stdouts."""
    procs = [subprocess.Popen([sys.executable, str(script), *args],
                              env=_env(port, workers, w), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for w in range(workers)]
    try:
        res = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, res):
        assert p.returncode == 0, err[-3000:]
    return [out for out, _ in res]


def _port_server(port: int, workers: int) -> subprocess.Popen:
    port_lib()                     # built before the workers connect
    return subprocess.Popen([sys.executable, "-m", "byteps_tpu_torch.server"],
                            env=_env(port, workers), cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _wait_server(server: subprocess.Popen) -> None:
    """The server exits 0 once every worker shut down."""
    try:
        _, err = server.communicate(timeout=60)
    finally:
        server.kill()
    assert server.returncode == 0, err[-3000:]


def _epoch_lines(out: str) -> list:
    return [ln for ln in out.splitlines() if EPOCH_LINE.match(ln)]


def test_mnist_example_prints_the_reference_examples_lines():
    from byteps_tpu import server as rserver
    from byteps_tpu_torch import server as tserver

    reference_lib()
    port = tserver.any_port(
        lambda p: rserver.start_server(port=p, num_workers=2,
                                       engine_threads=2), next_port())
    try:
        ref = _workers(ROOT / "examples" / "pytorch" / "train_mnist_byteps.py",
                       MNIST_ARGS, port, 2)
    finally:
        rserver.stop_server()
    port = next_port()
    server = _port_server(port, 2)
    try:
        got = _workers(EXAMPLES / "train_mnist_byteps.py",
                       MNIST_ARGS + ["--device", "cpu", "--print-digest"],
                       port, 2)
    finally:
        _wait_server(server)
    for w in range(2):
        want = _epoch_lines(ref[w])
        assert len(want) == 1 and want[0].startswith(f"[worker {w}] epoch 0")
        assert _epoch_lines(got[w]) == want
    digests = [re.findall(r"params sha1=([0-9a-f]{40})", o) for o in got]
    assert len(digests[0]) == 1 and digests[0] == digests[1]


def test_benchmark_example_prints_its_rate():
    port = next_port()
    server = _port_server(port, 1)
    try:
        out = _workers(EXAMPLES / "benchmark_byteps.py",
                       ["--device", "cpu", "--num-iters", "2",
                        "--tensor-mb", "1"], port, 1)
    finally:
        _wait_server(server)
    line = [ln for ln in out[0].splitlines() if ln.startswith("push_pull:")]
    assert len(line) == 1, out[0]
    m = re.match(r"push_pull: (\S+) GB/s/worker \(1 MB in (\S+) ms, "
                 r"1 workers\)$", line[0])
    assert m and float(m.group(1)) > 0 and float(m.group(2)) > 0, line


@pytest.mark.parametrize("script", ["train_mnist_byteps.py",
                                    "benchmark_byteps.py"])
def test_examples_take_the_device_flag_defaulting_to_cuda(script):
    out = subprocess.run(
        [sys.executable, str(EXAMPLES / script),
         "--help"], env=_env(next_port(), 1), cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout
    src = (EXAMPLES / script).read_text()
    assert 'ap.add_argument("--device", default="cuda"' in src
    assert "python -m byteps_tpu_torch.server" in src
    imports = re.findall(r"^(?:import|from) (\S+)", src, re.M)
    assert "byteps_tpu_torch.torch" in imports
    assert not [m for m in imports if m.split(".")[0] in ("jax",
                                                          "byteps_tpu")]
