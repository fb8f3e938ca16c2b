"""The port's checkpoint/resume (``byteps_tpu_torch/checkpoint.py``),
twin of ``tests/test_checkpoint.py``: a round trip keeps values and
layout, a checkpoint written on dp=4 restores onto dp=2 × tp=2 (gloo
ranks on the CPU), a restored onebit + EF run continues bit for bit as
the uninterrupted one (moments, step count, EF residual and codec key
included), retention / cadence / the writer gate, a crash-resume against
a live port server (``worker:kill`` then ``rejoin()``), a missing step
raises, and the ``LeafLike`` skeleton (the reference's ``abstract_like``).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from byteps_tpu_torch.checkpoint import (
    Checkpointer,
    LeafLike,
    abstract_like,
    load_train_state,
    restore_checkpoint,
    save_checkpoint,
    train_state,
)
from byteps_tpu_torch.models import GPTConfig, make_gpt_train_step
from byteps_tpu_torch.models.convert import flat_leaves

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent / "helpers"))
from dcn_fixtures import next_port, port_lib  # noqa: E402
from test_torch_ring import run_group  # noqa: E402

torch.set_num_threads(1)
CFG = GPTConfig.tiny()
ONEBIT_EF = {"compressor": "onebit", "ef": "vanilla"}


def _factory(cp=None):
    return make_gpt_train_step(
        CFG, compression_params=cp, partition_bytes=4096, device="cpu",
        generator=torch.Generator().manual_seed(0))


def _batch(seed=1, B=4, S=32):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, CFG.vocab_size, (B, S + 1), generator=g)
    return toks[:, :-1], toks[:, 1:]


def _trees_equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_trees_equal, a, b))
    if torch.is_tensor(a):
        return (torch.is_tensor(b) and a.dtype == b.dtype
                and a.device == b.device and torch.equal(a, b))
    return a == b


def test_roundtrip_preserves_values_and_layout(tmp_path):
    step, params, opt = _factory(ONEBIT_EF)
    step(*_batch())
    state, specs = train_state(1, params, opt)
    save_checkpoint(tmp_path / "ck", 1, state, specs=specs)
    restored = restore_checkpoint(tmp_path / "ck", like=state, specs=specs)
    assert _trees_equal(restored, state)
    # new buffers, laid out as the live ones
    assert all(r.data_ptr() != p.data_ptr() for r, p in zip(
        flat_leaves_of(restored["params"]), flat_leaves(params)))
    # without a target the saved tree comes back as saved: the EF stacked
    # over the world's one rank
    raw = restore_checkpoint(tmp_path / "ck")
    assert tuple(raw["opt"]["ef"].shape) == (1,) + tuple(opt.ef.shape)


def flat_leaves_of(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat_leaves_of(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in flat_leaves_of(v)]
    return [tree]


# every rank: save on dp=4 (rank 0 writes), then restore onto dp=2 x tp=2
# in the same processes and write what it holds beside its expected block
_RESHARD = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
store, io = sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from byteps_tpu_torch.checkpoint import (Checkpointer, load_train_state,
                                         train_state)
from byteps_tpu_torch.models import GPTConfig, gpt_init, make_gpt_train_step
from byteps_tpu_torch.models.convert import (flat_leaves, flat_specs,
                                             param_specs, shard_leaf)
from byteps_tpu_torch.parallel.mesh import MeshAxes, make_mesh
cfg = GPTConfig.tiny()
g = torch.Generator().manual_seed(1)
toks = torch.randint(0, cfg.vocab_size, (8, 33), generator=g)
mesh_a = make_mesh(MeshAxes(dp=4))
step, params, opt = make_gpt_train_step(
    cfg, mesh=mesh_a, device="cpu", generator=torch.Generator().manual_seed(0))
step(toks[:, :-1], toks[:, 1:])
state, specs = train_state(1, params, opt, mesh=mesh_a)
ck = Checkpointer(io + "/ck", async_save=True, should_save=rank == 0)
ck.save(1, state, specs=specs, mesh=mesh_a)
ck.wait()
dist.barrier()
whole = [p.detach().clone() for p in flat_leaves(params)]
moments = [opt.optimizer.state[p]["exp_avg_sq"].clone() for p in opt.params]
mesh_b = make_mesh(MeshAxes(dp=2, tp=2))
init = gpt_init(cfg, torch.Generator().manual_seed(5), device="cpu")
step_b, params_b, opt_b = make_gpt_train_step(cfg, mesh=mesh_b,
                                              init_params=init, device="cpu")
like, specs_b = train_state(0, params_b, opt_b, mesh=mesh_b)
got = load_train_state(params_b, opt_b,
                       ck.restore(like, specs=specs_b, mesh=mesh_b))
bspecs = flat_specs(param_specs(cfg, mesh_b))
out = {"step": np.array(got), "count": np.array(opt_b.count)}
for i, (p, w, m, sp) in enumerate(zip(flat_leaves(params_b), whole, moments,
                                      bspecs)):
    out[f"got{i}"] = p.detach().numpy()
    out[f"want{i}"] = shard_leaf(w, sp, mesh_b).numpy()
    out[f"gotm{i}"] = opt_b.optimizer.state[p]["exp_avg_sq"].numpy()
    out[f"wantm{i}"] = shard_leaf(m, sp, mesh_b).numpy()
    out[f"sharded{i}"] = np.array(tuple(p.shape) != tuple(w.shape))
np.savez(io + f"/out{rank}.npz", **out)
step_b(toks[:, :-1], toks[:, 1:])      # the restored state trains on
print(json.dumps({"ok": True}))
"""


def test_restore_onto_different_topology(tmp_path):
    """Save on dp=4, resume on dp=2 × tp=2: every rank holds its tp block
    of the dp=4 parameters and moments."""
    outs = run_group(tmp_path, 4, _RESHARD)
    for out in outs:
        assert int(out["step"]) == 1 and int(out["count"]) == 1
        n = sum(1 for k in out if k.startswith("got") and
                not k.startswith("gotm"))
        assert any(bool(out[f"sharded{i}"]) for i in range(n))
        for i in range(n):
            np.testing.assert_array_equal(out[f"got{i}"], out[f"want{i}"])
            np.testing.assert_array_equal(out[f"gotm{i}"], out[f"wantm{i}"])


def test_resume_is_bitwise_exact(tmp_path):
    """ckpt@2 + 2 more steps == 4 uninterrupted steps under onebit + EF:
    losses, parameters, AdamW moments and step count, EF residual."""
    tok, tgt = _batch()
    step, params, opt = _factory(ONEBIT_EF)
    for _ in range(2):
        step(tok, tgt)
    with Checkpointer(tmp_path / "ck", max_to_keep=2) as ck:
        state, specs = train_state(2, params, opt)
        assert ck.save(2, state, specs=specs)      # asynchronous
        cont = [float(step(tok, tgt)) for _ in range(2)]
        step2, params2, opt2 = _factory(ONEBIT_EF)
        like, specs2 = train_state(0, params2, opt2)
        assert load_train_state(params2, opt2, ck.restore(
            like, specs=specs2)) == 2
    res = [float(step2(tok, tgt)) for _ in range(2)]
    assert cont == res
    for a, b in zip(flat_leaves(params), flat_leaves(params2)):
        assert torch.equal(a, b)
    assert torch.equal(opt.ef, opt2.ef)
    assert opt.count == opt2.count == 4
    for a, b in zip(opt.params, opt2.params):
        sa, sb = opt.optimizer.state[a], opt2.optimizer.state[b]
        assert set(sa) == set(sb)
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_manager_retention_cadence_and_gating(tmp_path):
    x = torch.arange(8.0)
    with Checkpointer(tmp_path / "mgr", max_to_keep=2,
                      save_interval_steps=2, async_save=True) as ck:
        started = [ck.save(s, {"x": x * s}) for s in range(7)]
        ck.wait()
        assert started == [True, False, True, False, True, False, True]
        assert ck.all_steps() == [4, 6]
        assert ck.latest_step() == 6
        r = ck.restore({"x": x})
        assert torch.equal(r["x"], x * 6)
        r4 = ck.restore({"x": x}, step=4)
        assert torch.equal(r4["x"], x * 4)
        assert ck.save(5, {"x": x}) is False     # behind the latest step
    with Checkpointer(tmp_path / "mgr", should_save=False) as ro:
        assert ro.save(99, {"x": x}) is False
        assert ro.latest_step() == 6
    with pytest.raises(ValueError, match="target"):
        restore_checkpoint(tmp_path / "mgr", like={"y": x})
    with pytest.raises(ValueError, match="block"):
        restore_checkpoint(tmp_path / "mgr", like={"x": torch.zeros(4)})


def test_crash_resume_matches_uninterrupted(tmp_path):
    """A loop aggregating through a live port server checkpoints every
    step; an injected ``worker:kill`` crashes it mid-step. A fresh worker
    (a restarted process) rejoins — adopting the server's round
    watermarks, without which its re-minted round 1 would be dropped as
    a replay — restores the latest checkpoint, and ends bit for bit where
    the uninterrupted run does."""
    from byteps_tpu_torch.common.faults import (FaultPlan,
                                                WorkerKilledError,
                                                parse_fault_spec)
    from byteps_tpu_torch.server import PSWorker, start_server, stop_server

    port_lib()
    n, steps, lr = 128, 6, np.float32(0.05)
    base = np.linspace(-1.0, 1.0, n).astype(np.float32)

    def grad_of(params, step):
        return (0.1 * params + base * np.float32(step + 1)).astype(
            np.float32)

    def train(worker, params, ck, start_step, end_step):
        for s in range(start_step, end_step):
            v = worker.push(0, grad_of(params, s))
            agg = worker.pull(0, n, v)
            params = (params - lr * agg).astype(np.float32)
            if ck is not None:
                ck.save(s, {"params": torch.from_numpy(params), "step": s},
                        force=True)
                ck.wait()
        return params

    try:
        port = next_port()
        start_server(port=port, num_workers=1, engine_threads=2,
                     async_mode=False)
        w = PSWorker(servers=[("127.0.0.1", port)], worker_id=0)
        w.init_key(0, n * 4)
        params_clean = train(w, np.zeros(n, np.float32), None, 0, steps)
        w.close()
        stop_server()

        port = next_port()
        start_server(port=port, num_workers=1, engine_threads=2,
                     async_mode=False)
        servers = [("127.0.0.1", port)]
        plan = FaultPlan(parse_fault_spec("worker:kill@step=10.."), seed=0)
        w = PSWorker(servers=servers, worker_id=0, fault_plan=plan)
        w.init_key(0, n * 4)
        with Checkpointer(tmp_path / "crash", max_to_keep=None,
                          async_save=False) as ck:
            with pytest.raises(WorkerKilledError):
                train(w, np.zeros(n, np.float32), ck, 0, steps)
            assert ck.latest_step() == 3
            w2 = PSWorker(servers=servers, worker_id=0)
            w2.rejoin()
            versions, nbytes = w2.export_rounds()
            assert versions.get(0) == 4 and nbytes.get(0) == n * 4
            restored = ck.restore({"params": torch.zeros(n), "step": 0})
        resumed = train(w2, restored["params"].numpy(), None,
                        restored["step"] + 1, steps)
        np.testing.assert_array_equal(resumed, params_clean)
        w2.shutdown()
    finally:
        stop_server()


def test_restore_missing_raises(tmp_path):
    with Checkpointer(tmp_path / "empty") as ck:
        with pytest.raises(FileNotFoundError):
            ck.restore({"x": torch.zeros(2)})


def test_abstract_like_carries_layouts(tmp_path):
    _, params, opt = _factory()
    state, specs = train_state(0, params, opt)
    ab = abstract_like(state)
    leaves = flat_leaves_of(state)
    for conc, a in zip(leaves, flat_leaves_of(ab)):
        if torch.is_tensor(conc):
            assert isinstance(a, LeafLike)
            assert (a.shape, a.dtype, a.device) == (
                tuple(conc.shape), conc.dtype, conc.device)
        else:
            assert a == conc
    save_checkpoint(tmp_path / "ck", 0, state, specs=specs)
    got = restore_checkpoint(tmp_path / "ck", like=ab, specs=specs)
    assert _trees_equal(got, state)
