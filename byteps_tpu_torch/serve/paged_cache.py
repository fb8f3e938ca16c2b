"""Block-paged KV cache: PagedAttention's memory model for the port.

Counterpart of ``byteps_tpu/serve/paged_cache.py``. The cache is a
preallocated pool of fixed-size KV blocks plus a per-request block
table mapping logical position ``p`` to slot ``(table[p // bs], p % bs)``,
so requests of any length pack one device batch and a freed request's
blocks serve the next admission at once. Blocks are refcounted and a
radix prefix index maps token content to committed prefill blocks:
requests sharing a prompt prefix map the same physical pages, with
copy-on-write at the divergence block and LRU eviction of cached-but-
idle pages before any allocation fails.

The paged views reproduce the dense cache's contract exactly: a
gathered view is zero at and past the request's fill level, attention
masks with the same global-offset rule, and quantized pools reuse
``_quantize_block`` — so a served request's greedy tokens equal a solo
``make_generate_fn`` run's.

The prefix index is keyed by adapter: :meth:`PagedKVCache.match_prefix`
and :meth:`~PagedKVCache.commit_prefix` take a ``namespace`` (the
request's adapter id, None for the base model) and keep one radix root
per namespace, so a hit only ever adopts K/V computed under the same
weights. The reference keys the index on tokens alone, so a tenant whose
adapter targets ``wk``/``wv`` can adopt pages another adapter computed
(ROADMAP C); the port departs from it there to keep its exactness
contract.

Where the reference donated the pool to its jitted steps
(``paged_cache.py:852-857``, ``:903-905``), the port updates the pool
tensors in place: the decode and prefill steps scatter their new rows
straight into ``PagedKVCache.state``.

Three layers:

* :class:`PagedKVCache` — the host-side allocator: pool tensors, block
  tables, per-block refcounts, the radix prefix index,
  alloc/adopt/CoW/free/defrag and leak accounting. Block 0 is a
  reserved scratch block that padded decode rows write into.
* :func:`make_paged_decode_fn` — one packed decode step: R requests at
  their own positions, per-row rope and masks, scatter the new token's
  K/V into the pool, gather per-request views, attend (plain PyTorch:
  per-row offsets are the reference's jnp path too); with an adapter
  pool's slabs, each row adds its own adapter's delta through the
  segmented LoRA kernel.
* :func:`make_paged_prefill_fn` — one prefill chunk of one request:
  gather its blocks into a dense :class:`KVCache` view, run the stock
  ``gpt_apply_cached`` (the forward kernel on CUDA), scatter the newly
  written rows back.

Both factories take ``tp_axis`` (a mesh ``Axis``): the parameters are
then this rank's Megatron shards, the pool holds this rank's kv heads
(``PagedKVCache(h_loc=)``), and the attention output, the MLP's ``w2``
and a grafted ``wo``/``w2`` delta are summed over tp, as the reference's
steps under ``shard_map`` do. Every tp rank runs the same rows, so the
host that drives them must make the same decisions on each
(``serve/scheduler.py``).
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from byteps_tpu_torch.common.metrics import get_registry
from byteps_tpu_torch.models.generate import (
    KVCache,
    _quantize_block,
    gpt_apply_cached,
)
from byteps_tpu_torch.models.gpt import (
    GPTConfig,
    _bias,
    _mlp,
    _readout,
    resolve_norm,
    resolve_rope,
    rope_rotate,
    with_lora,
)
from byteps_tpu_torch.ops.backend import resolve_device
from byteps_tpu_torch.ops.flash_attention import attention_lse
from byteps_tpu_torch.ops.segmented_lora import segmented_lora_delta
from byteps_tpu_torch.parallel.tp import (
    col_parallel_matmul,
    row_parallel_matmul,
)


class PoolState(NamedTuple):
    """The device half of the paged cache.

    k/v: ``(n_layers, num_blocks, block_size, h_kv, head_dim)`` in
    ``cfg.dtype``, or int8 with ``k_scale``/``v_scale``
    ``(n_layers, num_blocks, block_size, h_kv)`` f32 absmax scales.
    """

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


class PoolExhausted(RuntimeError):
    """A block allocation could not be satisfied — the scheduler's cue
    to preempt."""


# pool instance sequence for per-pool gauge series
_POOL_SEQ = itertools.count()


class _PrefixNode:
    """One committed KV block in the radix prefix index: the edge label
    is the exact ``block_size`` token ids the block holds (children are
    keyed by the raw token bytes, so two contexts never collide);
    ``tick`` is the LRU clock stamped on every lookup touch."""

    __slots__ = ("key", "tokens", "block", "parent", "children", "tick")

    def __init__(self, key: bytes, tokens: np.ndarray, block: int,
                 parent: Optional["_PrefixNode"]):
        self.key = key
        self.tokens = tokens
        self.block = block
        self.parent = parent
        self.children: Dict[bytes, "_PrefixNode"] = {}
        self.tick = 0


class PagedKVCache:
    """Host-side block allocator + per-request block tables over a pool
    on ``device`` (the card unless told otherwise).

    ``pool_blocks <= 0`` sizes the pool for ``max_batch`` full-length
    requests plus the reserved scratch block 0. ``blocks_per_req``
    (``ceil(max_seq / block_size)``) caps a table; the steps take
    width-bucketed table rows so a short request's gather tracks its
    length instead of max_seq.
    """

    def __init__(self, cfg: GPTConfig, *, block_size: int,
                 pool_blocks: int, max_batch: int,
                 h_loc: Optional[int] = None, quant: bool = False,
                 device=None):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1; got {block_size}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.block_size = block_size
        self.blocks_per_req = -(-cfg.max_seq // block_size)
        if pool_blocks <= 0:
            pool_blocks = 1 + max_batch * self.blocks_per_req
        if pool_blocks < 2:
            raise ValueError(
                f"pool_blocks ({pool_blocks}) must hold the reserved "
                "scratch block plus at least one allocatable block")
        self.pool_blocks = pool_blocks
        self.quant = quant
        h = h_loc if h_loc is not None else cfg.kv_heads
        shape = (cfg.n_layers, pool_blocks, block_size, h, cfg.head_dim)
        dev = self.device
        if quant:
            self.state = PoolState(
                k=torch.zeros(shape, dtype=torch.int8, device=dev),
                v=torch.zeros(shape, dtype=torch.int8, device=dev),
                k_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                    device=dev),
                v_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                    device=dev),
            )
        else:
            self.state = PoolState(
                k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
            )
        # LIFO free list over blocks 1..NB-1 (0 = scratch, reserved)
        self._free: List[int] = list(range(pool_blocks - 1, 0, -1))
        self._tables: Dict[object, List[int]] = {}
        # one ref per table entry referencing the block plus one for its
        # prefix-index node; a shared block frees only at refcount 0
        self._ref: List[int] = [0] * pool_blocks
        self._in_use = 0                  # distinct blocks with ref > 0
        # one radix root per namespace (adapter id; None = base model)
        self._roots: Dict[Any, _PrefixNode] = {}
        self._node_of_block: Dict[int, _PrefixNode] = {}
        self._lru_tick = 0
        # bumped on every commit_prefix insert: the scheduler's
        # mid-prefill re-match skips the walk when nothing new committed
        self.index_version = 0
        # blocks adopted from a KV migration (write_payloads)
        self.migrated_in_blocks = 0
        _reg = get_registry()
        seq = next(_POOL_SEQ)
        self._g_in_use = _reg.gauge(f"serve.pool{seq}.kv_blocks_in_use")
        self._g_prefix = _reg.gauge(f"serve.pool{seq}.prefix_blocks")
        self._c_alloc_fail = _reg.counter("serve.kv_alloc_failures")
        self._c_prefix_evict = _reg.counter("serve.prefix_evictions")

    # -- accounting ---------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def _live_blocks(self) -> set:
        """The distinct blocks referenced by a live table or the prefix
        index, computed from the references themselves."""
        live = {b for t in self._tables.values() for b in t}
        live.update(self._node_of_block)
        return live

    @property
    def blocks_in_use(self) -> int:
        """Distinct physical blocks occupied (shared pages count once)."""
        return self._in_use

    @property
    def prefix_blocks(self) -> int:
        """Blocks held by the radix prefix index."""
        return len(self._node_of_block)

    def leaked_blocks(self) -> int:
        """Blocks neither free nor referenced — must be 0 at drain."""
        return (self.pool_blocks - 1) - len(self._free) \
            - len(self._live_blocks())

    def reclaimable_blocks(self, exclude=()) -> int:
        """Prefix-index blocks no live table references (refcount 1),
        which LRU eviction could free; ``exclude`` masks blocks the
        caller is about to adopt."""
        ex = set(exclude)
        return sum(1 for b in self._node_of_block
                   if self._ref[b] == 1 and b not in ex)

    def check_refcounts(self) -> None:
        """Test invariant: ``_ref`` equals the ground truth (table
        entries + index nodes) for every block. Raises on drift."""
        want = [0] * self.pool_blocks
        for t in self._tables.values():
            for b in t:
                want[b] += 1
        for b in self._node_of_block:
            want[b] += 1
        if self._ref != want:
            raise AssertionError(f"refcount drift: {self._ref} != {want}")
        if self._in_use != len(self._live_blocks()):
            raise AssertionError((self._in_use, len(self._live_blocks())))
        if self.leaked_blocks() < 0:
            raise AssertionError(self.leaked_blocks())

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def table_len(self, rid) -> int:
        return len(self._tables[rid])

    # -- allocation ---------------------------------------------------------
    def register(self, rid) -> None:
        if rid in self._tables:
            raise ValueError(f"request {rid!r} already registered")
        self._tables[rid] = []

    def _alloc_block(self) -> int:
        b = self._free.pop()
        self._ref[b] = 1
        self._in_use += 1
        return b

    def _decref(self, b: int) -> None:
        r = self._ref[b] - 1
        if r < 0:
            raise RuntimeError(
                f"refcount underflow on block {b} — a release/evict "
                "path double-freed a shared page")
        self._ref[b] = r
        if r == 0:
            self._free.append(b)
            self._in_use -= 1

    def _exhausted_msg(self, rid, need: int) -> str:
        live = {b for t in self._tables.values() for b in t}
        cached_idle = sum(1 for b in self._node_of_block if b not in live)
        return (f"request {rid!r} needs {need} more block(s), pool has "
                f"{len(self._free)} free — occupancy: "
                f"{self.pool_blocks - 1} allocatable = {len(live)} live + "
                f"{cached_idle} cached-prefix + {len(self._free)} free")

    def ensure(self, rid, n_tokens: int) -> None:
        """Grow ``rid``'s table to cover ``n_tokens`` positions with fresh
        private blocks, evicting idle prefix pages first; raises
        :class:`PoolExhausted` (allocating nothing) when the pool can't."""
        table = self._tables[rid]
        need = self.blocks_for(n_tokens) - len(table)
        if need <= 0:
            return
        if need > len(self._free):
            self._evict_prefix(need - len(self._free))
        if need > len(self._free):
            self._c_alloc_fail.inc()
            raise PoolExhausted(self._exhausted_msg(rid, need))
        for _ in range(need):
            table.append(self._alloc_block())
        self._g_in_use.set(self.blocks_in_use)

    def release(self, rid) -> None:
        """Drop ``rid``'s table; each block frees at refcount 0."""
        table = self._tables.pop(rid)
        for b in reversed(table):
            self._decref(b)
        self._g_in_use.set(self.blocks_in_use)

    def adopt_prefix(self, rid, blocks: List[int]) -> None:
        """Seed ``rid``'s empty table with shared prefix pages from a
        :meth:`match_prefix` hit (read-only until CoW'd)."""
        table = self._tables[rid]
        if table:
            raise ValueError(
                f"adopt_prefix needs an empty table; {rid!r} holds "
                f"{len(table)} block(s)")
        for b in blocks:
            self._ref[b] += 1
            table.append(b)
        self._g_in_use.set(self.blocks_in_use)

    def readopt_prefix(self, rid, blocks: List[int],
                       first_block: int) -> int:
        """Mid-prefill adoption: swap table entries ``[first_block,
        first_block + len(blocks))`` for pages a sibling committed after
        this request was admitted; the displaced blocks drop a ref."""
        table = self._tables[rid]
        swapped = 0
        for i, b in enumerate(blocks):
            bi = first_block + i
            old = table[bi]
            if old == b:
                continue
            self._ref[b] += 1
            self._decref(old)
            table[bi] = b
            swapped += 1
        if swapped:
            self._g_in_use.set(self.blocks_in_use)
        return swapped

    def ensure_writable(self, rid, lo: int, hi: int) -> int:
        """Copy-on-write every block covering token positions ``[lo,
        hi)`` whose refcount is > 1 (k/v and scales, in place on the
        pool). Returns the number of blocks copied."""
        if hi <= lo:
            return 0
        table = self._tables[rid]
        copied = 0
        for bi in range(lo // self.block_size, -(-hi // self.block_size)):
            b = table[bi]
            if self._ref[b] <= 1:
                continue
            if not self._free:
                self._evict_prefix(1)
            if not self._free:
                self._c_alloc_fail.inc()
                raise PoolExhausted(self._exhausted_msg(rid, 1))
            nb = self._alloc_block()
            for t in self.state:
                if t is not None:
                    t[:, nb] = t[:, b]
            self._decref(b)
            table[bi] = nb
            copied += 1
        if copied:
            self._g_in_use.set(self.blocks_in_use)
        return copied

    # -- radix prefix index -------------------------------------------------
    def _touch(self) -> int:
        self._lru_tick += 1
        return self._lru_tick

    def match_prefix(self, tokens, full_blocks_only: bool = False,
                     namespace=None):
        """Longest prefix of ``tokens`` committed under ``namespace``:
        ``(blocks, n_tokens)``, a chain of full-block hits plus optionally
        one divergence block matched on a partial leading run (unless
        ``full_blocks_only``)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        bs = self.block_size
        blocks: List[int] = []
        matched = 0
        tick = self._touch()
        node = self._roots.get(namespace)
        if node is None:
            return blocks, matched
        while matched + bs <= tokens.size:
            child = node.children.get(tokens[matched:matched + bs].tobytes())
            if child is None:
                break
            child.tick = tick
            blocks.append(child.block)
            matched += bs
            node = child
        rem = tokens[matched:]
        if rem.size and not full_blocks_only:
            best, best_n = None, 0
            for child in node.children.values():
                m = min(rem.size, child.tokens.size)
                n = int(np.cumprod(child.tokens[:m] == rem[:m]).sum())
                if n > best_n:
                    best, best_n = child, n
            if best is not None:
                best.tick = tick
                blocks.append(best.block)
                matched += best_n
        return blocks, matched

    def commit_prefix(self, rid, tokens, n_tokens: int,
                      namespace=None) -> int:
        """Publish ``rid``'s fully written leading blocks (covering
        ``tokens[:n_tokens]``) into ``namespace``'s index; each new node
        holds one ref. Returns the number of nodes inserted."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        bs = self.block_size
        table = self._tables[rid]
        node = self._roots.get(namespace)
        if node is None:
            node = self._roots[namespace] = _PrefixNode(
                b"", np.zeros(0, np.int32), -1, None)
        inserted = 0
        tick = self._touch()
        for bi in range(n_tokens // bs):
            seg = tokens[bi * bs:(bi + 1) * bs]
            key = seg.tobytes()
            child = node.children.get(key)
            if child is None:
                b = table[bi]
                if b in self._node_of_block:
                    break     # never alias one page into two chains
                child = _PrefixNode(key, seg.copy(), b, node)
                node.children[key] = child
                self._node_of_block[b] = child
                self._ref[b] += 1
                inserted += 1
            # an existing node may hold a different (content-identical)
            # block; the chain continues through the index's block
            child.tick = tick
            node = child
        if inserted:
            self.index_version += 1
            self._g_prefix.set(len(self._node_of_block))
        return inserted

    def _evict_node(self, node: _PrefixNode) -> None:
        for child in list(node.children.values()):
            self._evict_node(child)
        del node.parent.children[node.key]
        del self._node_of_block[node.block]
        self._decref(node.block)
        self._c_prefix_evict.inc()

    def _evict_prefix(self, want_free: int) -> int:
        """LRU-evict idle prefix subtrees (refcount-1 nodes) until
        ``want_free`` blocks came back or nothing reclaimable remains."""
        freed0 = len(self._free)
        victims = sorted((n for n in self._node_of_block.values()
                          if self._ref[n.block] == 1),
                         key=lambda n: n.tick)
        for n in victims:
            if len(self._free) - freed0 >= want_free:
                break
            if self._node_of_block.get(n.block) is not n:
                continue      # went down with an ancestor's subtree
            self._evict_node(n)
        self._g_prefix.set(len(self._node_of_block))
        return len(self._free) - freed0

    def drop_prefix_cache(self) -> int:
        """Release every cached prefix page; live tables keep theirs."""
        n = len(self._node_of_block)
        for root in self._roots.values():
            for child in list(root.children.values()):
                self._evict_node(child)
        self._g_prefix.set(0)
        self._g_in_use.set(self.blocks_in_use)
        return n

    def table_row(self, rid, width: Optional[int] = None) -> np.ndarray:
        """``(width,)`` int32 physical-block row (default
        ``blocks_per_req``); the unallocated tail points at scratch
        block 0, whose positions the gather's zero mask keeps out."""
        w = self.blocks_per_req if width is None else width
        t = self._tables[rid]
        if w < len(t):
            raise ValueError(f"width {w} < live table {len(t)}")
        row = np.zeros(w, np.int32)
        row[:len(t)] = t
        return row

    # -- migration payloads (serve/kv_wire.py) -------------------------------
    def snapshot_blocks(self, rid, lo: int, hi: int):
        """Host copies of ``rid``'s table blocks ``[lo, hi)`` as
        ``{block_idx: BlockPayload}``: one device gather and one copy to
        the host per pool array, whatever the block count. The bytes are
        the pool's own (a bf16 pool's as raw 16-bit words), copied
        verbatim; rows at or past the fill level carry whatever the block
        held, which the receiving side's gather masks, as it does here."""
        from byteps_tpu_torch.serve.kv_wire import BlockPayload

        if hi <= lo:
            return {}
        blocks = self._tables[rid][lo:hi]
        idx = torch.as_tensor(blocks, dtype=torch.int64, device=self.device)
        host = [None if t is None else _to_host(t[:, idx])
                for t in self.state]                    # (L, n, bs, h[, D])
        return {lo + i: BlockPayload(*(None if a is None else a[:, i]
                                       for a in host))
                for i in range(len(blocks))}

    def write_payloads(self, block_ids, payloads) -> None:
        """Scatter migrated block contents into physical ``block_ids``:
        one copy to the device and one scatter per pool array, whatever
        the block count. The payloads hold the pool's own bytes (the wire
        round-trips bytes, never values), so the write is bit-exact."""
        if not block_ids:
            return
        idx = torch.as_tensor(list(block_ids), dtype=torch.int64,
                              device=self.device)
        for i, t in enumerate(self.state):
            if t is None:
                continue
            rows = np.stack([np.asarray(p[i]) for p in payloads], axis=1)
            t[:, idx] = _to_device(rows, t.dtype, self.device)
        self.migrated_in_blocks += len(block_ids)

    def defrag(self) -> int:
        """Compact live blocks to the lowest physical ids, rewriting
        every table, the prefix index and the refcounts (a shared page
        moves once and its aliases follow). Returns blocks moved."""
        live = sorted(self._live_blocks())
        perm = np.arange(self.pool_blocks)
        moved = 0
        for new_id, old_id in enumerate(live, start=1):
            perm[new_id] = old_id
            if new_id != old_id:
                moved += 1
        if moved == 0:
            self._free = list(range(self.pool_blocks - 1, len(live), -1))
            return 0
        remap = {old: new for new, old in enumerate(live, start=1)}
        src = torch.as_tensor(perm, device=self.device)
        self.state = PoolState(*(None if t is None else t[:, src]
                                 for t in self.state))
        for t in self._tables.values():
            t[:] = [remap[b] for b in t]
        ref = [0] * self.pool_blocks
        for old, new in remap.items():
            ref[new] = self._ref[old]
        self._ref = ref
        self._node_of_block = {remap[b]: n
                               for b, n in self._node_of_block.items()}
        for new, node in self._node_of_block.items():
            node.block = new
        self._free = list(range(self.pool_blocks - 1, len(live), -1))
        return moved


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A pool slice's bytes as a numpy array: a bf16 slice as its raw
    16-bit words (numpy has no bfloat16), never a cast."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.uint16)
    return t.cpu().numpy()


def _to_device(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """Inverse of :func:`_to_host`: the same bytes as a ``dtype`` tensor
    on ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t.to(dtype)


def _gather_view(pool_l: torch.Tensor, scale_l: Optional[torch.Tensor],
                 table: torch.Tensor, length: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """One layer's attention-ready per-request views.

    pool_l: (NB, bs, h, D); table: (R, n_blocks) int64; length: (R,)
    fill levels. Returns (R, n_blocks*bs, h, D) in ``dtype``, zero at
    and past each row's fill level — exactly the dense cache's state."""
    g = pool_l[table]                                # (R, nb, bs, h, D)
    S = g.shape[1] * g.shape[2]
    g = g.reshape(g.shape[0], S, *g.shape[3:])
    if scale_l is not None:
        s = scale_l[table].reshape(g.shape[0], S, -1)
        g = g.float() * s[..., None]                 # _cache_read dequant
    g = g.to(dtype)
    keep = torch.arange(S, device=g.device)[None, :] < length[:, None]
    return torch.where(keep[..., None, None], g, 0.0)


def make_paged_decode_fn(cfg: GPTConfig, block_size: int, tp_axis=None):
    """Build the packed decode step.

    ``step(params, pool, toks, pos, tables, slabs=None, slots=None) ->
    logits (R, vocab) f32``:
    R requests each feed one token at their own position ``pos[r]``
    (keys [0, pos) live); ``toks``/``pos`` (R,) and ``tables`` (R, W)
    are int tensors on the pool's device. The new K/V rows are written
    into ``pool`` in place. Padded rows pass pos=0 with an all-scratch
    table row and their logits are ignored. Table rows may alias shared
    prefix pages: the scheduler CoWs the write-target block first, so the
    scatter only lands in a private block (or scratch). Dense-MLP
    families only, as the reference's step. ``tp_axis`` as in the module
    docstring.

    Multi-tenant arm: ``slabs`` is an ``AdapterPool``'s ``{target: {"a":
    (n_slots, L, d_in, rb), "b": (n_slots, L, rb, d_out)}}`` and
    ``slots`` an ``(R,)`` int32 tensor of per-row pool slots; each row
    adds its own adapter's delta beside every targeted frozen matmul
    (``segmented_lora_delta`` on the layer's strided slab slice, at the
    reference's points). Slot 0 is the pool's zero adapter: base-model
    and padded rows add exactly 0.0. The reference keys its compiled
    steps on the pool's geometry (``lora_sig``); this step compiles
    nothing, so it needs no such key."""
    resolve_rope(cfg)
    norm_fn, norm_eps = resolve_norm(cfg)
    rope_base = cfg.rope_base if cfg.pos_embedding == "rope" else 0.0
    head_dim, use_bias = cfg.head_dim, cfg.use_bias

    def _block(x, p, pool: PoolState, li, blk, off, pos, tables, seg):
        R = x.shape[0]
        h = norm_fn(x, p["ln1_g"], p.get("ln1_b"), norm_eps)
        q = col_parallel_matmul(h, p["wq"].to(x.dtype),
                                _bias(p, "bq", x, use_bias))
        k = col_parallel_matmul(h, p["wk"].to(x.dtype),
                                _bias(p, "bk", x, use_bias))
        v = col_parallel_matmul(h, p["wv"].to(x.dtype),
                                _bias(p, "bv", x, use_bias))
        q = with_lora(q, h, p, "wq", seg)
        k = with_lora(k, h, p, "wk", seg)
        v = with_lora(v, h, p, "wv", seg)
        h_loc = q.shape[-1] // head_dim
        kv_loc = k.shape[-1] // head_dim
        q = q.reshape(R, 1, h_loc, head_dim)
        k = k.reshape(R, 1, kv_loc, head_dim)
        v = v.reshape(R, 1, kv_loc, head_dim)
        if rope_base > 0.0:
            q = rope_rotate(q, pos[:, None], rope_base)
            k = rope_rotate(k, pos[:, None], rope_base)
        # scatter the new token's K/V into each request's block slot
        # (quantized first in quant mode, as _cache_write does)
        if pool.k_scale is not None:
            kq, ks = _quantize_block(k)
            vq, vs = _quantize_block(v)
            pool.k[li, blk, off] = kq[:, 0]
            pool.v[li, blk, off] = vq[:, 0]
            pool.k_scale[li, blk, off] = ks[:, 0]
            pool.v_scale[li, blk, off] = vs[:, 0]
        else:
            pool.k[li, blk, off] = k[:, 0].to(pool.k.dtype)
            pool.v[li, blk, off] = v[:, 0].to(pool.v.dtype)
        length = pos + 1                       # new key included
        kk = _gather_view(pool.k[li], None if pool.k_scale is None
                          else pool.k_scale[li], tables, length, x.dtype)
        vv = _gather_view(pool.v[li], None if pool.v_scale is None
                          else pool.v_scale[li], tables, length, x.dtype)
        o, _ = attention_lse(q, kk, vv, pos, 0, causal=True)
        o = o.reshape(R, 1, h_loc * head_dim)
        attn_out = row_parallel_matmul(o, p["wo"].to(x.dtype), tp_axis,
                                       _bias(p, "bo", x, use_bias))
        x = x + with_lora(attn_out, o, p, "wo", seg, tp_axis)
        if "moe" in p:
            raise NotImplementedError(
                "the paged decode step serves dense-MLP GPT families "
                "only, as the reference's does "
                "(byteps_tpu/serve/paged_cache.py:844): MoE routing is not "
                "paged there either")
        h2 = norm_fn(x, p["ln2_g"], p.get("ln2_b"), norm_eps)
        return x + _mlp(h2, p, tp_axis, use_bias=use_bias, seg=seg)

    def _seg_for(slabs, slots, li):
        """Layer ``li``'s per-row delta of the pooled adapters: the
        kernel reads the ``[:, li]`` slab slice through its slot stride."""
        def seg(name, xin):
            sl = slabs.get(name)
            if sl is None:
                return None
            return segmented_lora_delta(xin, sl["a"][:, li], sl["b"][:, li],
                                        slots)
        return seg

    @torch.no_grad()
    def step(params, pool: PoolState, toks, pos, tables, slabs=None,
             slots=None) -> torch.Tensor:
        x = params["wte"][toks[:, None]]
        if cfg.pos_embedding != "rope":
            x = x + params["wpe"][pos[:, None]]
        x = x.to(cfg.dtype)
        blk = tables.gather(1, (pos // block_size)[:, None])[:, 0]
        off = pos % block_size
        for li, p in enumerate(params["blocks"]):
            seg = None if slabs is None else _seg_for(slabs, slots, li)
            x = _block(x, p, pool, li, blk, off, pos, tables, seg)
        return _readout(params, x, norm_fn, norm_eps)[:, 0]

    return step


def make_paged_prefill_fn(cfg: GPTConfig, block_size: int, tp_axis=None):
    """Build the per-request prefill chunk.

    ``chunk(params, pool, tokens (1, C), pos0, table (W,), readout=True)
    -> logits (1, C, vocab) f32 or None``: gather the request's blocks
    into a dense :class:`KVCache` view of width ``W * block_size`` (zero
    past ``pos0``, int8 + scales in quant mode), run the stock
    ``gpt_apply_cached`` — the computation a solo prefill performs —
    and scatter the C newly written rows into ``pool`` in place. The
    table may alias shared prefix pages below ``pos0`` (read only);
    the written rows land in blocks the scheduler made private first.
    ``readout=False`` skips the vocab projection (intermediate chunks).
    ``tp_axis`` as in the module docstring."""
    L = cfg.n_layers

    @torch.no_grad()
    def chunk(params, pool: PoolState, tokens: torch.Tensor, pos0: int,
              table: torch.Tensor, readout: bool = True):
        C = tokens.shape[1]
        S = table.shape[0] * block_size
        if pos0 + C > S:
            raise ValueError(f"chunk [{pos0}, {pos0 + C}) overruns the "
                             f"table's {S} positions")

        def view(t):
            g = t[:, table].reshape(L, 1, S, *t.shape[3:])
            g[:, :, pos0:] = 0            # the dense cache past its fill
            return g

        quant = pool.k_scale is not None
        cache = KVCache(k=view(pool.k), v=view(pool.v), length=pos0,
                        k_scale=view(pool.k_scale) if quant else None,
                        v_scale=view(pool.v_scale) if quant else None)
        logits, cache = gpt_apply_cached(params, tokens, cache, cfg,
                                         tp_axis, readout=readout)
        positions = torch.arange(pos0, pos0 + C, device=table.device)
        blk = table[positions // block_size]
        off = positions % block_size
        pairs = [(pool.k, cache.k), (pool.v, cache.v)]
        if quant:
            pairs += [(pool.k_scale, cache.k_scale),
                      (pool.v_scale, cache.v_scale)]
        for dst, src in pairs:
            dst[:, blk, off] = src[:, 0, pos0:pos0 + C]
        return logits

    return chunk
