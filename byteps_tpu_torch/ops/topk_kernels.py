"""Block top-k selection, reconstruct-sum and the fused round trip: the
plain PyTorch versions and the dispatchers that send CUDA tensors to the
hand-written kernels (``csrc/topk.cu``).

Counterpart of ``byteps_tpu/ops/topk_kernels.py``. A chunk of
``block·rows`` elements is viewed as ``(block, rows)``: one winner per
lane c, over the strided set ``{c, c+rows, ...}``. The round trip views
its chunk as ``(J, g, 128)``: one winner per (j, lane) over g.

The winner rule is the Pallas kernels' strict first-max: the smallest
index where |x| equals the group's max |x|, not ``argmax``. So an
all-zero group picks index 0, -0.0 ties with 0.0, and a group holding a
NaN has no winner: its max is NaN, which equals nothing, so its index is
the group size (``block`` or ``g``), its value 0, its dense slots 0 and
its residual x. (The reference's jnp twin ``_select_jnp`` uses
``jnp.argmax`` and returns the NaN's index instead.) A winner's value is
``x + 0.0``, as the reference's one-hot sum gives it: -0.0 comes out as
0.0.

The reference sends shapes with ``rows % 128 != 0`` to its jnp twins, a
limit of the TPU's lanes (:func:`kernels_supported`, kept for the tests).
The CUDA kernels take any shape, so the ragged tail chunk of a gradient
runs them too: :func:`block_select`'s ``n`` marks the slots at or past
the chunk's length, which never win, as the reference's -1 padding does.

Select and the round trip split each group's rows over the threads of a
block and the blocks of a thread-block cluster on a launch plan that is
a function of the shapes alone (:func:`select_plan`,
:func:`roundtrip_plan`), so the grid follows the chunk, not the number
of groups; reconstruct-sum gives each warp a column slice and a stripe
of rows (:func:`reconstruct_plan`), so its grid follows the output.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from byteps_tpu_torch.ops import _build
from byteps_tpu_torch.ops.backend import check_kernel_input, launches

_LANES = 128
_INT32_MAX = 2 ** 31 - 1
# the kernels' launch limits (csrc/topk.cu): threads a block, blocks a
# cluster, rows a round-trip thread keeps in registers, rows a select
# thread loads at once; and the blocks a plan aims at: about two an SM of
# an H100's 132 for the round trip, one for select, whose blocks hold
# nothing between their reads and their one write (on an H100, select at
# the training tail took 0.43 us longer warm split over clusters of two
# than on 176 single blocks)
_MAX_THREADS = 512
_MAX_CLUSTER = 16
_RT_ROWS = 4
_SEL_ROWS = 8
_TARGET_BLOCKS = 256
_SEL_TARGET_BLOCKS = 128
# reconstruct-sum: rows a thread holds at most, threads a block, and the
# warps a plan aims at (about 6 an SM of an H100's 132: on an H100 the
# tail and a chunk ran fastest on 2-warp blocks of 6 to 8 rows a thread,
# cold and warm, `scripts/torch_topk_tc.py --plans`)
_RECON_ROWS = 8
_RECON_THREADS = 64
_RECON_TARGET_WARPS = 768
_GRID_Y = 65535


def kernels_supported(block: int, rows: int) -> bool:
    """The reference's gate for its Pallas kernels (a lane-aligned winner
    axis). It gates nothing here."""
    return rows % _LANES == 0 and block > 1


# --------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the kernels' golden)
# --------------------------------------------------------------------------
def first_max(xa: torch.Tensor, dim: int) -> torch.Tensor:
    """The winner rule on magnitudes ``xa``: min(index where xa ==
    max(xa)) along ``dim`` (kept, int32), the size of ``dim`` where the
    max is NaN."""
    size = xa.shape[dim]
    am = xa.amax(dim=dim, keepdim=True)
    shape = [1] * xa.ndim
    shape[dim] = size
    ii = torch.arange(size, dtype=torch.int32, device=xa.device).reshape(shape)
    return torch.where(xa == am, ii, size).amin(dim=dim, keepdim=True)


def _select_torch(x2d: torch.Tensor,
                  n: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    block, rows = x2d.shape
    xa = x2d.abs()
    if n is not None and n < block * rows:
        flat = torch.arange(block * rows, device=x2d.device).reshape(
            block, rows)
        xa = torch.where(flat < n, xa, -1.0)
    local = first_max(xa, 0)                                 # (1, rows)
    won = local < block
    vals = torch.where(won, x2d.gather(0, local.clamp(max=block - 1).long())
                       + 0.0, 0.0)
    return local[0], vals[0]


def _reconstruct_sum_torch(locals_: torch.Tensor, vals: torch.Tensor,
                           block: int) -> torch.Tensor:
    rr = torch.arange(block, dtype=torch.int32,
                      device=locals_.device)[:, None]
    acc = None
    for k in range(locals_.shape[0]):
        term = torch.where(rr == locals_[k][None, :], vals[k][None, :], 0.0)
        acc = term if acc is None else acc + term
    return acc


def _roundtrip_torch(x: torch.Tensor, J: int, g: int,
                     e: Optional[torch.Tensor]):
    x3 = (x if e is None else x + e).reshape(J, g, _LANES)
    local = first_max(x3.abs(), 1)                           # (J, 1, 128)
    ii = torch.arange(g, dtype=torch.int32, device=x.device)[None, :, None]
    dense = torch.where(ii == local, x3, 0.0)
    return dense.reshape(-1), (x3 - dense).reshape(-1)


# --------------------------------------------------------------------------
# launch plans: functions of the shapes alone
# --------------------------------------------------------------------------
class Plan(NamedTuple):
    """A select or round-trip launch: clusters of ``cluster`` blocks of
    ``threads``, each block holding ``rows`` consecutive rows of a group
    (the last one fewer) for ``width`` columns (select: 32 lanes; round
    trip: ``width`` 4-lane columns of a 128-lane tile); ``blocks`` in
    all. A reconstruct-sum launch (:func:`reconstruct_plan`) uses the
    same fields."""
    width: int
    cluster: int
    rows: int
    threads: int
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _target(cells: int, per_thread: int, most: int) -> int:
    """Blocks to aim at for ``cells`` thread-cells (an element of select,
    4 lanes of a round-trip row): ``most``, fewer for a small input (no
    fewer than 128 threads' full share a block)."""
    return min(most, _cdiv(cells, per_thread * 128))


def _split(height: int, columns: int, per_thread: int, width: int,
           target: int) -> Plan:
    """Split ``height`` rows of ``columns`` column slices of ``width``
    columns over clusters: as many blocks as it takes to reach ``target``
    or to give no thread more than ``per_thread`` rows, at most
    ``_MAX_CLUSTER`` a slice, none empty (no block for an empty input)."""
    if height == 0 or columns == 0:
        return Plan(width, 1, 1, 32, 0)
    smax = _MAX_THREADS // width
    c = max(_cdiv(target, columns), _cdiv(height, per_thread * smax))
    rows = _cdiv(height, min(c, _MAX_CLUSTER, height))
    c = _cdiv(height, rows)
    step = 32 // width                  # row-threads that fill a warp
    s = min(smax, _cdiv(_cdiv(rows, per_thread), step) * step)
    return Plan(width, c, rows, s * width, columns * c)


@functools.lru_cache(maxsize=None)
def select_plan(block: int, rows: int) -> Plan:
    """Select over (block, rows): 32 lanes a block, each thread loading up
    to 8 of its rows at once."""
    return _split(block, _cdiv(rows, 32), _SEL_ROWS, 32,
                  _target(block * rows, _SEL_ROWS, _SEL_TARGET_BLOCKS))


@functools.lru_cache(maxsize=None)
def roundtrip_plan(J: int, g: int) -> Plan:
    """The round trip over (J, g, 128): a block takes ``width`` 4-lane
    columns of a tile (128, 64, 32 or 16 lanes), each thread up to 4 rows
    in registers (taller groups are read twice). Of the widths, the plan
    that comes nearest the target block count, then keeps whole 128-byte
    row segments (width >= 8), then needs the smallest cluster (on an
    H100 the (80, 100) chunk took 7.4 us warm on clusters of 4 blocks of
    128 lanes, 5.9 on 320 blocks of 32 lanes and none), then is
    widest."""
    target = _target(J * g * 32, _RT_ROWS, _TARGET_BLOCKS)
    plans = [_split(g, J * (32 // lw), _RT_ROWS, lw, target)
             for lw in (32, 16, 8, 4)]
    return min(plans, key=lambda p: (-min(p.blocks, target), p.width < 8,
                                      p.cluster, -p.width))


@functools.lru_cache(maxsize=None)
def reconstruct_plan(K: int, block: int, rows: int) -> Plan:
    """Reconstruct-sum over (block, rows) from K payloads: a warp takes a
    128-column slice (``width`` 4 columns a thread) and a stripe of
    ``rows`` rows (at most 8, the fewest that keep the warps near the
    target), blocks of up to 2 warps on a grid of (slices / warps,
    stripes). Each thread holds its stripe's sums in registers while the K
    pairs stream in, so K does not change the plan."""
    slices = _cdiv(rows, _LANES)
    if block == 0 or slices == 0:
        return Plan(4, 1, 1, 32, 0)
    r = min(_RECON_ROWS, _cdiv(block * slices, _RECON_TARGET_WARPS))
    r = _cdiv(block, _cdiv(block, r))          # even stripes
    w = min(_RECON_THREADS // 32, slices)
    # the grid's second axis holds up to 65,535 stripes; a warp takes the
    # stripes past it in turn
    return Plan(4, 1, r, 32 * w,
                _cdiv(slices, w) * min(_cdiv(block, r), _GRID_Y))


# --------------------------------------------------------------------------
# the CUDA kernels
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("topk")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bps_topk_select.argtypes = [p, p, p, i, i, ll, i, i, i, p]
    lib.bps_topk_reconstruct_sum.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.bps_topk_roundtrip.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    for fn in (lib.bps_topk_select, lib.bps_topk_reconstruct_sum,
               lib.bps_topk_roundtrip):
        fn.restype = i
    return lib


def _launch(lib, name: str, counter: str, t: torch.Tensor, *args) -> None:
    with torch.cuda.device(t.device):
        rc = getattr(lib, name)(
            *args, torch.cuda.current_stream(t.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{counter} kernel launch failed: "
                           f"{_build.error_string(lib, rc)}")
    launches[counter] += 1


def _check_size(numel: int, what: str) -> None:
    # the kernels index in int32 where the reference does
    if numel > _INT32_MAX:
        raise ValueError(f"{what} has {numel} elements; the top-k kernels "
                         f"index up to 2^31 - 1")


def _select_cuda(x2d: torch.Tensor, n: int):
    check_kernel_input(x2d, "x2d", (torch.float32,))
    block, rows = x2d.shape
    local = torch.empty(rows, dtype=torch.int32, device=x2d.device)
    vals = torch.empty(rows, dtype=torch.float32, device=x2d.device)
    p = select_plan(block, rows)
    _launch(_lib(), "bps_topk_select", "topk_select", x2d, x2d.data_ptr(),
            local.data_ptr(), vals.data_ptr(), block, rows, n, p.cluster,
            p.rows, p.threads)
    return local, vals


def _reconstruct_sum_cuda(locals_: torch.Tensor, vals: torch.Tensor,
                          block: int) -> torch.Tensor:
    check_kernel_input(locals_, "locals_", (torch.int32,))
    check_kernel_input(vals, "vals", (torch.float32,), locals_.device)
    K, rows = locals_.shape
    out = torch.empty((block, rows), dtype=torch.float32,
                      device=locals_.device)
    # 16-byte accesses where every row starts aligned, else the 4-byte
    # variant
    vec = rows % 4 == 0 and all(t.data_ptr() % 16 == 0
                                for t in (locals_, vals, out))
    p = reconstruct_plan(K, block, rows)
    _launch(_lib(), "bps_topk_reconstruct_sum", "topk_reconstruct_sum",
            locals_, locals_.data_ptr(), vals.data_ptr(), out.data_ptr(), K,
            block, rows, p.rows, p.threads, int(vec))
    return out


def _roundtrip_cuda(x: torch.Tensor, J: int, g: int,
                    e: Optional[torch.Tensor]):
    check_kernel_input(x, "x", (torch.float32,))
    if e is not None:
        check_kernel_input(e, "e", (torch.float32,), x.device)
    dense = torch.empty_like(x)
    resid = torch.empty_like(x)
    ptrs = [t.data_ptr() for t in (x, e, dense, resid) if t is not None]
    vec = all(a % 16 == 0 for a in ptrs)   # else the 4-byte-load variant
    p = roundtrip_plan(J, g)
    _launch(_lib(), "bps_topk_roundtrip", "topk_roundtrip", x, x.data_ptr(),
            None if e is None else e.data_ptr(), dense.data_ptr(),
            resid.data_ptr(), J, g, p.width, p.cluster, p.rows, p.threads,
            int(vec))
    return dense, resid


# --------------------------------------------------------------------------
# public API (the reference's names)
# --------------------------------------------------------------------------
def block_select(x2d: torch.Tensor, n: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(block, rows) f32 → per lane, (winner row (rows,) int32, its value
    (rows,) f32). Slots at flat index ``r·rows + c >= n`` never win
    (``rows <= n <= block·rows``, so every lane keeps a slot)."""
    if x2d.ndim != 2:
        raise ValueError(f"block_select takes (block, rows); got "
                         f"{tuple(x2d.shape)}")
    block, rows = x2d.shape
    size = block * rows
    if n is None:
        n = size
    if not rows <= n <= size:
        raise ValueError(f"n={n} leaves a lane of ({block}, {rows}) without "
                         f"a slot or exceeds it")
    _check_size(size, "x2d")
    x2d = x2d.float()
    if x2d.is_cuda:
        return _select_cuda(x2d.contiguous(), n)
    return _select_torch(x2d, n)


def block_reconstruct_sum(locals_: torch.Tensor, vals: torch.Tensor,
                          block: int) -> torch.Tensor:
    """(K, rows) winner rows + values → Σ_k dense (block, rows) f32: payload
    0's dense term, then + payload k's in order k = 1..K-1 (so a lone
    -0.0 stays -0.0, as in the Pallas kernel, whose first add to 0.0
    XLA folds away)."""
    if locals_.ndim != 2 or vals.shape != locals_.shape:
        raise ValueError(f"locals_ {tuple(locals_.shape)} and vals "
                         f"{tuple(vals.shape)} must both be (K, rows)")
    K, rows = locals_.shape
    _check_size(block * rows, "the dense output")
    locals_, vals = locals_.to(torch.int32), vals.float()
    if K == 0:
        return torch.zeros((block, rows), dtype=torch.float32,
                           device=vals.device)
    if locals_.is_cuda:
        return _reconstruct_sum_cuda(locals_.contiguous(), vals.contiguous(),
                                     block)
    return _reconstruct_sum_torch(locals_, vals, block)


def block_roundtrip(x: torch.Tensor, J: int, g: int,
                    e: Optional[torch.Tensor] = None):
    """Flat (n = J·g·128,) f32, plus the error-feedback residual ``e`` when
    given → (D(C(x+e)), (x+e) − D(C(x+e))) flat, in one pass: the EF add,
    the first-max selection per (j, lane) group of ``(J, g, 128)``, the
    reconstruction and the new residual."""
    if x.shape != (J * g * _LANES,) or (e is not None and e.shape != x.shape):
        raise ValueError(f"block_roundtrip takes x (and e) of ({J}·{g}·128,) "
                         f"elements; got {tuple(x.shape)}")
    _check_size(x.shape[0], "x")
    x = x.float()
    e = None if e is None else e.float()
    if x.is_cuda:
        return _roundtrip_cuda(x.contiguous(), J, g,
                               None if e is None else e.contiguous())
    return _roundtrip_torch(x, J, g, e)
