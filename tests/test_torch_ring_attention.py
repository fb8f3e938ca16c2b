"""The port's ring attention (``byteps_tpu_torch.parallel.ring_attention``)
against the reference's, and ``merge_attention`` against its twin.

The same seeded q/k/v go through the reference's ``ring_attention`` and
``zigzag_ring_attention`` under ``shard_map`` on an sp mesh of the
conftest's CPU devices (its jnp route, and its flash route with the
Pallas kernels in interpret mode, as ``tests/test_flash_attention.py``
forces them), and through the port's at sp = 2 and 4 as gloo rank
processes (the plain versions of the flash kernels on CPU tensors). Each
rank's output block and the gradients of its local objective
``sum(o * w)`` (the ring's backward carries the other ranks' shares to
the owners of the k/v blocks, as the reference's ``ppermute`` transposes)
agree to 1e-5: contiguous and zigzag layouts, causal and not, MHA and
GQA (the narrow k/v rotate).
"""

import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from byteps_tpu.ops.flash_attention import merge_attention as j_merge
from byteps_tpu.parallel import MeshAxes as JAxes
from byteps_tpu.parallel import make_mesh as j_make_mesh
from byteps_tpu.parallel import ring_attention as j_ring
from byteps_tpu.parallel import zigzag_inverse as j_zinv
from byteps_tpu.parallel import zigzag_local_positions as j_zpos
from byteps_tpu.parallel import zigzag_permutation as j_zperm
from byteps_tpu.parallel import zigzag_ring_attention as j_zring
from byteps_tpu_torch.ops.flash_attention import merge_attention
from byteps_tpu_torch.parallel.mesh import Axis
from byteps_tpu_torch.parallel.ring_attention import (zigzag_inverse,
                                                      zigzag_local_positions,
                                                      zigzag_permutation)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_ring import run_group  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-5
B, S, H, HKV, D = 2, 64, 4, 2, 16
SPS = (2, 4)
# (name, layout, causal, kv heads)
CASES = (("ring_causal", "contiguous", True, H),
         ("ring_causal_gqa", "contiguous", True, HKV),
         ("ring_full", "contiguous", False, H),
         ("zigzag_causal", "zigzag", True, H),
         ("zigzag_causal_gqa", "zigzag", True, HKV),
         ("zigzag_full", "zigzag", False, H))

_RANK = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, n, store, io = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank,
                        world_size=n)
from byteps_tpu_torch.parallel.mesh import MeshAxes, collectives, make_mesh
from byteps_tpu_torch.parallel.ring_attention import (ring_attention,
                                                      zigzag_ring_attention)

d = np.load(f"{io}/in.npz")
with open(f"{io}/cases.json") as f:
    cases = json.load(f)
sp = make_mesh(MeshAxes(sp=n)).axis("sp")
out = {}
for name, layout, causal, _ in cases:
    blk = slice(sp.index * d["q"].shape[1] // n,
                (sp.index + 1) * d["q"].shape[1] // n)
    x = {k: torch.from_numpy(d[f"{name}_{k}"][:, blk].copy())
         for k in ("q", "k", "v", "w")}
    for k in ("q", "k", "v"):
        x[k].requires_grad_()
    fn = zigzag_ring_attention if layout == "zigzag" else ring_attention
    before = dict(collectives)
    o = fn(x["q"], x["k"], x["v"], sp, causal=causal)
    (o * x["w"]).sum().backward()
    out[f"{name}_o"] = o.detach().numpy()
    for k in ("q", "k", "v"):
        out[f"{name}_d{k}"] = x[k].grad.numpy()
    out[f"{name}_rotations"] = np.array(
        [collectives[k] - before[k] for k in ("sp_rotate_fwd",
                                              "sp_rotate_bwd")])
np.savez(f"{io}/out{rank}.npz", **out)
dist.barrier()
dist.destroy_process_group()
print(json.dumps({"rank": rank, "ok": True}))
"""


def _inputs():
    """Per case: q (B, S, H, D), k/v with the case's kv heads and w like
    q, in the case's layout (zigzag cases permuted per sp size later)."""
    rng = np.random.default_rng(11)
    out = {}
    for name, _, _, hkv in CASES:
        out[name] = {
            "q": rng.standard_normal((B, S, H, D)).astype(np.float32),
            "k": rng.standard_normal((B, S, hkv, D)).astype(np.float32),
            "v": rng.standard_normal((B, S, hkv, D)).astype(np.float32),
            "w": rng.standard_normal((B, S, H, D)).astype(np.float32)}
    return out


def _laid_out(x, layout, n):
    if layout != "zigzag":
        return x
    perm = np.asarray(j_zperm(S, n))
    return {k: v[:, perm] for k, v in x.items()}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """{sp: [each rank's outputs]} of the port's rings."""
    data = _inputs()
    res = {}
    for n in SPS:
        io = tmp_path_factory.mktemp(f"ring_attn{n}")
        arrays = {}
        for name, layout, _, _ in CASES:
            for k, v in _laid_out(data[name], layout, n).items():
                arrays[f"{name}_{k}"] = v
        arrays["q"] = data[CASES[0][0]]["q"]
        np.savez(io / "in.npz", **arrays)
        (io / "cases.json").write_text(json.dumps(CASES))
        res[n] = run_group(io, n, _RANK)
    return data, res


def _reference(x, layout, causal, n, backend):
    """The reference's per-device output and gradients of ``sum(o * w)``
    under shard_map over n sp devices, stacked on the sequence as the
    blocks lie."""
    fn = j_zring if layout == "zigzag" else j_ring
    mesh = j_make_mesh(JAxes(sp=n), devices=jax.devices()[:n])

    def local(q, k, v, w):
        def obj(q, k, v):
            return (fn(q, k, v, "sp", causal=causal) * w).sum()
        o = fn(q, k, v, "sp", causal=causal)
        return (o, *jax.grad(obj, argnums=(0, 1, 2))(q, k, v))

    spec = P(None, "sp")
    saved = os.environ.get("BYTEPS_KERNEL_BACKEND")
    if backend == "pallas":
        os.environ["BYTEPS_KERNEL_BACKEND"] = "pallas"
    else:
        os.environ.pop("BYTEPS_KERNEL_BACKEND", None)
    try:
        out = jax.jit(jax.shard_map(
            local, mesh=mesh, in_specs=(spec,) * 4, out_specs=(spec,) * 4,
            check_vma=False))(*(jnp.asarray(x[k])
                                for k in ("q", "k", "v", "w")))
    finally:
        if saved is None:
            os.environ.pop("BYTEPS_KERNEL_BACKEND", None)
        else:
            os.environ["BYTEPS_KERNEL_BACKEND"] = saved
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("case", [c[0] for c in CASES])
@pytest.mark.parametrize("n", SPS)
def test_ring_matches_reference(port, n, case, backend):
    data, res = port
    name, layout, causal, _ = next(c for c in CASES if c[0] == case)
    x = _laid_out(data[name], layout, n)
    want = _reference(x, layout, causal, n, backend)
    got = [np.concatenate([r[f"{name}_{k}"] for r in res[n]], axis=1)
           for k in ("o", "dq", "dk", "dv")]
    for what, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                   err_msg=f"{case} sp={n} {what}")


@pytest.mark.parametrize("n", SPS)
def test_ring_rotates_n_minus_1_times_each_way(port, n):
    _, res = port
    for r in res[n]:
        for name, *_ in CASES:
            np.testing.assert_array_equal(r[f"{name}_rotations"],
                                          [n - 1, n - 1])


def test_ring_equals_one_rank_attention(port):
    """Unpermuted back to the sequence, every ring's output is the
    one-rank attention of the whole sequence (the plain version)."""
    from byteps_tpu_torch.ops.flash_attention import attention_lse_torch

    data, res = port
    for n in SPS:
        for name, layout, causal, _ in CASES:
            x = data[name]
            o = np.concatenate([r[f"{name}_o"] for r in res[n]], axis=1)
            if layout == "zigzag":
                o = o[:, np.asarray(zigzag_inverse(S, n))]
            want = attention_lse_torch(*(torch.from_numpy(x[k])
                                         for k in ("q", "k", "v")), 0, 0,
                                       causal=causal)[0].numpy()
            np.testing.assert_allclose(o, want, rtol=TOL, atol=TOL,
                                       err_msg=f"{name} sp={n}")


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_zigzag_maps_match_reference(n):
    S_ = 8 * n
    np.testing.assert_array_equal(zigzag_permutation(S_, n).numpy(),
                                  np.asarray(j_zperm(S_, n)))
    np.testing.assert_array_equal(zigzag_inverse(S_, n).numpy(),
                                  np.asarray(j_zinv(S_, n)))
    mesh = j_make_mesh(JAxes(sp=n), devices=jax.devices()[:n]) \
        if n > 1 else None
    for i in range(n):
        got = zigzag_local_positions(S_ // n, Axis("sp", n, i,
                                                    tuple(range(n))))
        if mesh is None:
            want = np.arange(S_)
        else:
            want = np.asarray(jax.jit(jax.shard_map(
                lambda: j_zpos(S_ // n, "sp")[None], mesh=mesh,
                in_specs=(), out_specs=P("sp"), check_vma=False))())[i]
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="divisible"):
        zigzag_permutation(S_ + 1, n)


@pytest.mark.parametrize("dead", ["a", "b", "both", "none"])
def test_merge_attention_matches_reference(dead):
    """merge_attention against the reference's, values and gradients
    into both o and both lse; a dead partial (lse = -1e30, o = 0) merges
    to exactly the other one."""
    rng = np.random.default_rng(5)
    o_a, o_b = (rng.standard_normal((2, 8, 3, 4)).astype(np.float32)
                for _ in range(2))
    lse_a, lse_b = (rng.standard_normal((2, 8, 3)).astype(np.float32)
                    for _ in range(2))
    if dead in ("a", "both"):
        o_a[:] = 0.0
        lse_a[:, ::2] = -1e30
        o_a[:, 1::2] = rng.standard_normal(o_a[:, 1::2].shape)
    if dead in ("b", "both"):
        o_b[:, ::2] = 0.0
        lse_b[:, ::2] = -1e30
    w = rng.standard_normal((2, 8, 3, 4)).astype(np.float32)
    wl = rng.standard_normal((2, 8, 3)).astype(np.float32)

    def j_obj(oa, la, ob, lb):
        o, lse = j_merge(oa, la, ob, lb)
        return (o * w).sum() + (jnp.where(lse > -1e29, lse, 0.0) * wl).sum()

    want = j_merge(o_a, lse_a, o_b, lse_b)
    want_g = jax.grad(j_obj, argnums=(0, 1, 2, 3))(o_a, lse_a, o_b, lse_b)
    t = [torch.from_numpy(a).requires_grad_() for a in (o_a, lse_a, o_b,
                                                        lse_b)]
    o, lse = merge_attention(*t)
    ((o * torch.from_numpy(w)).sum()
     + (torch.where(lse > -1e29, lse, 0.0) * torch.from_numpy(wl)).sum()
     ).backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want[0]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(want[1]),
                               rtol=TOL, atol=TOL)
    for g, wg in zip(t, want_g):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(wg),
                                   rtol=TOL, atol=TOL)
    if dead == "a":                # rows dead on a: exactly b's partial
        np.testing.assert_array_equal(o.detach().numpy()[:, ::2],
                                      o_b[:, ::2])
        np.testing.assert_array_equal(lse.detach().numpy()[:, ::2],
                                      lse_b[:, ::2])
    if dead == "both":
        assert (lse.detach().numpy()[:, ::2] <= -1e29).all()
        assert (o.detach().numpy()[:, ::2] == 0.0).all()
