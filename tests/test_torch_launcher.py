"""The port's launcher role dispatch (``python -m
byteps_tpu_torch.launcher``), twin of ``tests/test_launcher.py``, across a
REAL process boundary: rc conventions, per-child rank env, child-failure
teardown, the interposition of the group bootstrap — and the module stays
free of torch, jax and ``byteps_tpu`` at import, so a supervised child
starts without them.

Every subprocess here carries a hard timeout: a hung launcher is a
failure, not a stuck run.
"""

import os
import subprocess
import sys
import time

from byteps_tpu_torch.launcher import _wrap_global_group

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_T = 60  # hard cap (s) per launcher invocation


def _run(argv, extra_env=None, timeout=_T):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    for k in ("DMLC_ROLE", "DMLC_WORKER_ID", "DMLC_NUM_WORKER",
              "BYTEPS_LOCAL_SIZE", "BYTEPS_JAX_DISTRIBUTED"):
        env.pop(k, None)
    env.update(extra_env or {})
    return subprocess.run(
        [sys.executable, "-m", "byteps_tpu_torch.launcher", *argv],
        env=env, cwd=REPO, capture_output=True, text=True,
        timeout=timeout)


def test_help_exits_zero():
    r = _run(["--help"])
    assert r.returncode == 0
    assert "bpslaunch" in r.stdout
    assert "--child-worker" in r.stdout


def test_unknown_role_is_a_structured_rc2():
    r = _run([], extra_env={"DMLC_ROLE": "frobnicator"})
    assert r.returncode == 2


def test_worker_role_without_command_is_rc2():
    r = _run([], extra_env={"DMLC_ROLE": "worker", "DMLC_WORKER_ID": "0"})
    assert r.returncode == 2


def test_child_worker_without_servers_is_rc2():
    r = _run(["--child-worker"])
    assert r.returncode == 2


def test_per_child_rank_env(tmp_path):
    """local_size=2 single-host simulation: each child sees its own
    BYTEPS_LOCAL_RANK and (num_worker == local_size) a per-child
    DMLC_WORKER_ID — the reference launch.py contract."""
    code = (
        "import os, pathlib\n"
        "rank = os.environ['BYTEPS_LOCAL_RANK']\n"
        "pathlib.Path(os.environ['RANK_DIR'], rank).write_text(\n"
        "    ' '.join([rank, os.environ['BYTEPS_LOCAL_SIZE'],\n"
        "              os.environ['DMLC_WORKER_ID']]))\n")
    r = _run(["python", "-c", code], extra_env={
        "DMLC_ROLE": "worker", "BYTEPS_LOCAL_SIZE": "2",
        "DMLC_NUM_WORKER": "2", "DMLC_WORKER_ID": "0",
        "RANK_DIR": str(tmp_path)})
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "0").read_text() == "0 2 0"
    assert (tmp_path / "1").read_text() == "1 2 1"


def test_child_failure_tears_the_job_down():
    """Fail-fast: rank 0 exits rc=3 while rank 1 would sleep 60s — the
    launcher must kill the sibling and return 3 long before that."""
    code = (
        "import os, sys, time\n"
        "if os.environ['BYTEPS_LOCAL_RANK'] == '0':\n"
        "    sys.exit(3)\n"
        "time.sleep(60)\n")
    t0 = time.monotonic()
    r = _run(["python", "-c", code], extra_env={
        "DMLC_ROLE": "worker", "BYTEPS_LOCAL_SIZE": "2",
        "DMLC_NUM_WORKER": "2", "DMLC_WORKER_ID": "0"})
    elapsed = time.monotonic() - t0
    assert r.returncode == 3
    assert elapsed < 30, f"teardown took {elapsed:.1f}s — sibling leaked"


def test_launcher_imports_no_torch_and_wraps_python_commands():
    """Importing the launcher pulls in neither torch nor jax nor the
    reference package; the bootstrap goes after the interpreter's own
    flags, and ``-m``/``-c`` commands stay unwrapped, as the
    reference's."""
    probe = ("import sys\n"
             "import byteps_tpu_torch.launcher\n"
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('torch', 'jax', 'byteps_tpu')))")
    out = subprocess.run([sys.executable, "-c", probe],
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
                         capture_output=True, text=True, timeout=_T)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    boot = ["-m", "byteps_tpu_torch._boot"]
    assert _wrap_global_group(["python", "-u", "t.py", "--x"]) == (
        ["python", "-u"] + boot + ["t.py", "--x"])
    assert _wrap_global_group(["python3", "t.py"]) == (
        ["python3"] + boot + ["t.py"])
    for cmd in (["python", "-m", "pkg"], ["python", "-c", "pass"],
                ["./train"]):
        assert _wrap_global_group(cmd) == cmd
