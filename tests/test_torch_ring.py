"""The port's ring transport (``ops/ring_collective_kernels.py``) against
the reference's.

Groups of 3, 4 and 8 ranks: processes on the ``gloo`` backend (a
``FileStore`` in the test's directory), each started once for the module
and computing all its cases, that import only torch and the port. Their
plain versions (one ``batch_isend_irecv`` round a hop) are held against:

* at n = 3 and 4, the reference's ``ppermute`` twins (``_collect_jnp``,
  ``_allgather_jnp``, ``_presum_jnp``) under ``shard_map`` on a 3- and
  4-device sub-mesh, in f32 and int32, at ``(n, 4, 128)`` and the
  unaligned ``(n, 21)``;
* at n = 8, the interpret-mode Pallas kernels (``backend="pallas"``) at
  the reference's own shapes (``tests/test_ops_pallas.py``).

Every comparison is exact, presum included: it is the same chain of f32
adds in the same order. uint8 rows and fp8 rows move as bytes,
unchanged. The tree calls (``ring_collect_tree``, ``ring_allgather_tree``:
every leaf of a payload in one call) at n = 2, 3 and 4, on onebit's two
leaves (int32 words ``(n, 40)``, an f32 scale ``(n, 1)``) and an odd
uint8 leaf of 1,003 bytes, equal the per-leaf calls and the reference's
per-leaf twins; the landing slot's layout of a payload
(``slot_layout``) is a pure function of the leaves' shapes and dtypes.
With one rank each function is a passthrough that needs no process
group. The CUDA kernels are held against these plain versions on the
card by ``chip_smoke.py`` (phase ``ring``)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from byteps_tpu.ops.ring_collective_kernels import \
    ring_allgather as r_allgather
from byteps_tpu.ops.ring_collective_kernels import ring_collect as r_collect
from byteps_tpu.ops.ring_collective_kernels import ring_presum as r_presum
from byteps_tpu_torch.ops import _build
from byteps_tpu_torch.ops.ring_collective_kernels import (LEAF_ALIGN,
                                                          ring_allgather,
                                                          ring_collect,
                                                          ring_presum,
                                                          slot_layout)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
# (name, per-row shape) of the cases every group runs
ROWS = {"aligned": (4, 128), "unaligned": (21,)}
DTYPES = {"f32": np.float32, "i32": np.int32}
GROUPS = (2, 3, 4, 8)
# a onebit payload's leaves and an odd uint8 leaf: (dtype, row shape)
TREE = {"words": (np.int32, (40,)), "scale": (np.float32, (1,)),
        "odd": (np.uint8, (1003,))}


def _inputs(n: int) -> dict:
    """Every rank's input of every case, stacked on a leading rank axis:
    collect and presum take (n, n, *row), gather (n, *row)."""
    rng = np.random.default_rng(100 + n)
    d = {}
    for rname, row in ROWS.items():
        for dname, dt in DTYPES.items():
            x = (rng.standard_normal((n, n) + row) * 100).astype(dt)
            d[f"{rname}_{dname}"] = x
            d[f"{rname}_{dname}_g"] = x[:, 0]
    d["u8"] = rng.integers(0, 256, (n, n, 1003), dtype=np.uint8)
    d["fp8"] = rng.integers(0, 256, (n, n, 37), dtype=np.uint8)
    for k, (dt, row) in TREE.items():
        if dt == np.uint8:
            d["tree_" + k] = rng.integers(0, 256, (n, n) + row, dtype=dt)
        else:
            d["tree_" + k] = (rng.standard_normal((n, n) + row)
                              * 1e4).astype(dt)
    return d


_RANK = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from byteps_tpu_torch.ops.ring_collective_kernels import (
    ring_allgather, ring_allgather_tree, ring_collect, ring_collect_tree,
    ring_presum)

rank, world, store_path, io = int(sys.argv[1]), int(sys.argv[2]), \
    sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                        rank=rank, world_size=world)
d = np.load(io + "/in.npz")
out = {}
tree = {}
for k in d.files:
    x = torch.as_tensor(d[k][rank])
    if k.startswith("tree_"):  # one payload: its leaves in one call
        tree[k[5:]] = x
    elif k == "fp8":          # fp8 rows move as their bytes
        x = x.view(torch.float8_e4m3fn)
        out[k] = ring_collect(x).view(torch.uint8).numpy()
        out[k + "_g"] = ring_allgather(x[0]).view(torch.uint8).numpy()
    elif k.endswith("_g"):
        out[k] = ring_allgather(x).numpy()
    else:
        out[k] = ring_collect(x).numpy()
        if x.dtype == torch.float32:
            out[k + "_presum"] = ring_presum(x).numpy()
rows = {k: x[0] for k, x in tree.items()}
for op, got in (("collect", ring_collect_tree(tree)),
                ("gather", ring_allgather_tree(rows))):
    assert list(got) == list(tree), (op, list(got))
    for k, v in got.items():
        out[f"tree_{op}_{k}"] = v.numpy()
for k, x in tree.items():
    out[f"leaf_collect_{k}"] = ring_collect(x).numpy()
    out[f"leaf_gather_{k}"] = ring_allgather(x[0]).numpy()
np.savez(f"{io}/out{rank}.npz", **out)
dist.barrier()
dist.destroy_process_group()
print(json.dumps({"rank": rank, "ok": True}))
"""


def run_group(io: Path, n: int, script: str, timeout: int = 240):
    """Start ``n`` gloo ranks running ``script`` (argv: rank, world,
    store path, io dir); each writes ``io/out<rank>.npz``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(n), str(io / "store"),
         str(io)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(n)]
    try:
        res = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, res):
        assert p.returncode == 0, se[-3000:]
        assert json.loads(so.strip().splitlines()[-1])["ok"]
    return [dict(np.load(io / f"out{r}.npz")) for r in range(n)]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """{n: (inputs, [each rank's outputs])} for n = 3, 4, 8."""
    res = {}
    for n in GROUPS:
        io = tmp_path_factory.mktemp(f"ring{n}")
        d = _inputs(n)
        np.savez(io / "in.npz", **d)
        res[n] = (d, run_group(io, n, _RANK))
    return res


def _mesh(n):
    return jax.make_mesh((n,), ("dp",), devices=jax.devices()[:n])


def _shmap(n, f, x):
    """Run ``f`` on each device's block of ``x`` (sharded on axis 0)."""
    return np.asarray(jax.jit(jax.shard_map(
        f, mesh=_mesh(n), in_specs=P("dp"), out_specs=P("dp"),
        check_vma=False))(jnp.asarray(x)))


_REF = {"collect": r_collect, "gather": r_allgather, "presum": r_presum}


def _ref(op, x, n, backend="jnp"):
    """The reference's per-device results of ``op`` (its ``ppermute`` twin,
    or with ``backend="pallas"`` its kernel in interpret mode) on the
    per-rank inputs ``x`` stacked on axis 0: (n, *out), one per device."""
    blk = x.shape[1:]
    flat = x.reshape((n * blk[0],) + blk[1:])
    return _shmap(n, lambda b: _REF[op](b.reshape(blk), "dp", n,
                                        backend=backend)[None], flat)


@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("rows", sorted(ROWS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_versions_equal_the_twins(groups, n, rows, dtype):
    d, outs = groups[n]
    key = f"{rows}_{dtype}"
    x = d[key]
    want = {key: _ref("collect", x, n),
            key + "_g": _ref("gather", d[key + "_g"], n)}
    if dtype == "f32":
        want[key + "_presum"] = _ref("presum", x, n)
    for r, o in enumerate(outs):
        for k, w in want.items():
            np.testing.assert_array_equal(o[k], w[r])
        # the semantics themselves: all_to_all and all_gather
        np.testing.assert_array_equal(o[key], x[:, r])
        np.testing.assert_array_equal(o[key + "_g"], d[key + "_g"])
    if dtype == "f32":              # and the column sums
        got = np.stack([o[key + "_presum"] for o in outs])
        np.testing.assert_allclose(got, x.sum(0), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_versions_equal_the_pallas_kernels_at_n8(groups, dtype):
    """The reference's own shapes: (8, 4, 128) rows, interpret mode."""
    d, outs = groups[8]
    key = f"aligned_{dtype}"
    want = _ref("collect", d[key], 8, backend="pallas")
    wantg = _ref("gather", d[key + "_g"], 8, backend="pallas")
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o[key], want[r])
        np.testing.assert_array_equal(o[key + "_g"], wantg[r])
    if dtype == "f32":
        wants = _ref("presum", d[key], 8, backend="pallas")
        for r, o in enumerate(outs):
            np.testing.assert_array_equal(o[key + "_presum"], wants[r])


@pytest.mark.parametrize("n", GROUPS)
def test_bytes_move_unchanged(groups, n):
    """uint8 rows of an odd length, and fp8 rows carried as their bytes."""
    d, outs = groups[n]
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["u8"], d["u8"][:, r])
        np.testing.assert_array_equal(o["fp8"], d["fp8"][:, r])
        np.testing.assert_array_equal(o["fp8_g"], d["fp8"][:, 0])


def test_n1_passthrough_needs_no_group():
    import torch.distributed as dist

    assert not (dist.is_available() and dist.is_initialized())
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (1, 4, 128)).astype(np.float32))
    for n in (1, None):
        assert ring_collect(x, n) is x
        assert torch.equal(ring_allgather(x[0], n), x)
        assert torch.equal(ring_presum(x, n), x[0])
    # the reference's own passthroughs agree
    xj = jnp.asarray(x.numpy())
    np.testing.assert_array_equal(np.asarray(r_collect(xj, "dp", 1)), x)
    np.testing.assert_array_equal(np.asarray(r_allgather(xj[0], "dp", 1)),
                                  x)
    np.testing.assert_array_equal(np.asarray(r_presum(xj, "dp", 1)), x[0])


def test_misuse_raises_without_touching_the_build(monkeypatch):
    def refuse(name):
        raise AssertionError(f"CPU call tried to load kernel {name}")

    monkeypatch.setattr(_build, "load", refuse)
    x = torch.zeros(2, 8)
    with pytest.raises(RuntimeError, match="process group"):
        ring_collect(x, 2)
    with pytest.raises(RuntimeError, match="process group"):
        ring_presum(x, 2)


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("op", ["collect", "gather"])
def test_tree_calls_equal_leaf_calls_and_twins(groups, n, op):
    """A payload of three leaves (onebit's words and scale, an odd uint8
    row) in one tree call: each leaf bit-equal to its own call and to the
    reference's per-leaf twin (``_collect_jnp``/``_allgather_jnp``) under
    ``shard_map``; the keys keep the payload's order."""
    d, outs = groups[n]
    for k in TREE:
        x = d["tree_" + k]
        x = x if op == "collect" else x[:, 0]
        want = _ref(op, x, n)
        for r, o in enumerate(outs):
            got = o[f"tree_{op}_{k}"]
            assert got.dtype == x.dtype
            np.testing.assert_array_equal(got, o[f"leaf_{op}_{k}"])
            np.testing.assert_array_equal(got, want[r])
            np.testing.assert_array_equal(got, x[:, r] if op == "collect"
                                          else x)


_LEAF_SETS = {
    "onebit": {"signs": ((16000,), torch.int32),
               "scale": ((1,), torch.float32)},
    "odd": {"words": ((40,), torch.int32), "scale": ((1,), torch.float32),
            "odd": ((1003,), torch.uint8)},
    "mixed": {"a": ((3, 5), torch.float16), "b": ((), torch.float64),
              "c": ((7,), torch.uint8), "d": ((0,), torch.float32),
              "e": ((2, 2, 2), torch.bfloat16)},
}


@pytest.mark.parametrize("name", sorted(_LEAF_SETS))
def test_slot_layout_is_aligned_packed_and_order_free(name):
    rows = _LEAF_SETS[name]
    layout, span = slot_layout(rows)
    assert sorted(layout) == sorted(rows)
    spans = []
    for k, (off, nbytes) in layout.items():
        shape, dtype = rows[k]
        assert off % LEAF_ALIGN == 0
        assert nbytes == int(np.prod(shape)) * dtype.itemsize
        spans.append((off, off + nbytes))
    spans.sort()
    for (_, end), (start, _) in zip(spans, spans[1:]):
        assert end <= start                      # no two leaves overlap
    assert span == sum(-(-nb // LEAF_ALIGN) * LEAF_ALIGN
                       for _, nb in layout.values())
    # any order the dict gives, the same layout
    for keys in (sorted(rows, reverse=True), list(rows)[1:] + list(rows)[:1]):
        assert slot_layout({k: rows[k] for k in keys}) == (layout, span)
