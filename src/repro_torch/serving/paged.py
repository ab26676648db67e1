"""Paged decode-cache scratchpad — the serving ladder's O6 rung (port of
``repro/serving/paged.py``: the block allocator, the block tables, the
block paging plan and the manager, on bf16 pools and on narrow int8 /
fp8 pools with one f32 scale per (block row, kv head)).

Every KV leaf is stored as a pool of fixed-size blocks, and each slot
owns a block table mapping logical block ``j`` (positions ``j*T ..
j*T+T-1``) to a physical pool row.  Capacity is the pool over the actual
per-request reservations (``min(n_prompt + max_new_tokens, max_seq)``),
so short requests admit more concurrency at equal memory.

Layering (the allocators are pure host code, testable without a device):

  * :class:`BlockAllocator` — free-list arithmetic over integer block
    ids.  Block 0 is the NULL block: unallocated table entries point at
    it, it is never handed out, its contents are write-garbage.
  * :class:`PagedAllocator` — per-slot block tables + reservation-based
    admission; drives the scheduler's admission gate (a request that fits
    ``max_seq`` but not the free blocks QUEUES, never raises).
  * :class:`BlockPagingPlan` — the tensor layer: pool leaves
    (L, R, T, KV, dh) in the stored dtype and, for narrow pools, scale
    leaves (L, R, KV) f32; the per-tick gather (pool -> dense per-slot
    view, dequantized), the single-block scatter of the gather decode
    step and the whole-view scatter of the gather prefill / verify steps
    (re-quantized), geometry and bytes.
  * :class:`PagedCacheManager` — the pool + tables behind the contiguous
    manager's engine-facing surface, plus the INSERT of a prefilled
    dense state and the copy-on-admit defrag ``compact``.

Token identity with the contiguous path rests on one invariant: a slot
at position ``p`` has itself written every position ``< p`` (its blocks
are reserved up front), position ``p`` is written before attention reads
it, and every position ``> p`` is masked before the softmax.

The recurrent-state row pool (``StatePool``/``StatePagingPlan``) is not
ported (ROADMAP A11).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.serving import kvquant

NULL_BLOCK = 0


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` positions."""
    return -(-max(n_tokens, 0) // block_size)


def split_cache(cache, quantized: bool):
    """(pool leaves, scale leaves or None) of a paged cache: a narrow pool
    travels as a ``{"pool", "scale"}`` bundle, a wide one bare."""
    if quantized:
        return cache["pool"], cache["scale"]
    return cache, None


class BlockAllocator:
    """Fixed pool of KV blocks with a LIFO free list.

    ``n_blocks`` is the number of *allocatable* blocks; physical pool
    storage has ``n_blocks + 1`` rows (row 0 is the reserved NULL block).
    """

    def __init__(self, n_blocks: int):
        if n_blocks < 1:
            raise ValueError(f"need at least one block (got {n_blocks})")
        self.n_blocks = n_blocks
        self._free = list(range(n_blocks, 0, -1))   # pop() -> lowest id

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def allocate(self, n: int) -> list:
        """Take ``n`` blocks off the free list; raises if short (callers
        gate on ``free_blocks`` first — the scheduler's admission gate)."""
        if n > len(self._free):
            raise RuntimeError(
                f"block pool exhausted: want {n}, free {len(self._free)} "
                f"of {self.n_blocks} (admission gate should have queued)")
        return [self._free.pop() for _ in range(n)]

    def release(self, blocks) -> None:
        live = set(self._free)
        for b in blocks:
            if b == NULL_BLOCK:
                continue
            if b in live or not (1 <= b <= self.n_blocks):
                raise RuntimeError(f"double/invalid free of block {b}")
            live.add(b)
            self._free.append(b)

    def rebuild(self, n_held: int) -> None:
        """Reset to blocks ``1..n_held`` held and the rest free (the
        compacted layout), keeping the free-list representation in this
        class only."""
        self._free = list(range(self.n_blocks, n_held, -1))


class PagedAllocator:
    """Per-slot block tables over a :class:`BlockAllocator` (pure host
    arithmetic: numpy tables, python free list)."""

    def __init__(self, batch_size: int, max_seq: int, *,
                 block_size: int = 16, pool_blocks: int = 0):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1 (got {block_size})")
        self.B = batch_size
        self.max_seq = max_seq
        self.block_size = block_size
        self.blocks_per_seq = blocks_for(max_seq, block_size)
        # 0 = auto: equal worst-case capacity to the contiguous cache.
        self.pool_blocks = pool_blocks or batch_size * self.blocks_per_seq
        if self.pool_blocks < 1:
            raise ValueError(
                f"pool_blocks must be >= 1 (got {self.pool_blocks})")
        self.allocator = BlockAllocator(self.pool_blocks)
        # tables[i, j] = physical block of slot i's logical block j
        self.tables = np.full((batch_size, self.blocks_per_seq),
                              NULL_BLOCK, np.int32)
        self._held = [0] * batch_size      # blocks held per slot

    # -- admission gate + lifecycle (wired to Scheduler callbacks) ----------
    def reserved_tokens(self, req) -> int:
        """Positions the request can ever write: prompt + budget, clipped
        to the engine's ``max_seq`` horizon."""
        return min(req.n_prompt + req.max_new_tokens, self.max_seq)

    def blocks_needed(self, req) -> int:
        return blocks_for(self.reserved_tokens(req), self.block_size)

    def can_admit(self, req) -> bool:
        """The scheduler's admission gate: a request that fits max_seq but
        not the remaining free blocks queues (never raises)."""
        return self.blocks_needed(req) <= self.allocator.free_blocks

    def infeasible_reason(self, req):
        """The scheduler's SUBMIT gate: an error string when the
        request's reservation exceeds the TOTAL pool (no retirement can
        ever make room), else None."""
        need = self.blocks_needed(req)
        if need > self.pool_blocks:
            return (f"reservation of {need} KV blocks "
                    f"({self.reserved_tokens(req)} tokens at block size "
                    f"{self.block_size}) can never fit the total pool of "
                    f"{self.pool_blocks} blocks — shrink the request or "
                    f"enlarge kv_pool_blocks")
        return None

    def admit_slot(self, i: int, req) -> None:
        """Allocate the request's full reservation into slot ``i``'s
        table (up-front reservation = no mid-flight exhaustion)."""
        if self._held[i]:
            raise RuntimeError(f"slot {i} admitted while holding blocks")
        self.tables[i, :] = NULL_BLOCK
        self.grow_slot(i, self.reserved_tokens(req))

    def grow_slot(self, i: int, total_tokens: int) -> int:
        """Grow slot ``i``'s table to cover ``total_tokens`` positions
        (clipped to ``max_seq``), allocating exactly ``blocks_for(total) -
        held`` new blocks: a chunk that ends mid-block shares its active
        block with the next, so growing by totals never double-counts it.
        Returns the number of blocks added."""
        want = blocks_for(min(total_tokens, self.max_seq), self.block_size)
        delta = want - self._held[i]
        if delta <= 0:
            return 0
        self.tables[i, self._held[i]:want] = self.allocator.allocate(delta)
        self._held[i] = want
        return delta

    def release_slot(self, i: int, req=None) -> None:
        n = self._held[i]
        if n:
            self.allocator.release(self.tables[i, :n].tolist())
        self.tables[i, :] = NULL_BLOCK
        self._held[i] = 0

    # -- accounting ---------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return self.allocator.free_blocks

    @property
    def capacity_tokens(self) -> int:
        return self.pool_blocks * self.block_size

    def check_conservation(self) -> None:
        """allocated + free == total, and no block is in two places."""
        held = [b for row, n in zip(self.tables, self._held)
                for b in row[:n].tolist()]
        free = self.allocator._free
        if len(held) + len(free) != self.pool_blocks:
            raise AssertionError(f"blocks not conserved: held {held}, "
                                 f"free {free}")
        if set(held) & set(free):
            raise AssertionError("block both held and free")
        if len(set(held)) != len(held):
            raise AssertionError("block held twice")


class BlockPagingPlan:
    """Pool layout of the dense family's KV leaves.

    Every cache leaf ``(L, B, S, KV, dh)`` (batch at axis 1, sequence
    right after it — ``cache_axes``) becomes a pool leaf
    ``(L, R, T, KV, dh)`` with ``R = pool_blocks + 1`` rows (row 0 =
    NULL), stored in ``kv_dtype``: the cache's own dtype for "bf16", or
    1-byte words for "int8" / "fp8" with a scale leaf ``(L, R, KV)`` f32
    beside each (one absmax scale per block row and kv head; a layer's
    slice is the kernels' contiguous (R, KV) operand).  The gather step's
    two halves live here: :meth:`gather` builds the dense per-slot view
    ``(L, B, nb*T, KV, dh)`` through the tables, dequantizing a narrow
    pool, and :meth:`scatter` writes back the one block each slot wrote,
    re-quantizing it.
    """

    def __init__(self, model, batch_size: int, max_seq: int,
                 block_size: int, pool_blocks: int, *,
                 kv_dtype: str = "bf16"):
        self.B = batch_size
        self.max_seq = max_seq
        self.T = block_size
        self.nb = blocks_for(max_seq, block_size)
        self.pool_rows = pool_blocks + 1
        self.kv_dtype = kvquant.validate_kv_dtype(kv_dtype)
        self.quantized = kvquant.is_quantized(kv_dtype)
        self.store_dtype = kvquant.pool_dtype(kv_dtype)
        axes = model.cache_axes()
        # Bytes per token in the STORED dtype (what the pool holds and
        # the kernels read), in the dense compute-view dtype, and of
        # scales per pool block row (narrow pools).
        self.token_bytes = 0
        self.compute_token_bytes = 0
        self.scale_bytes_per_block = 0
        self.leaf_specs = {}
        for name, (shape, dtype) in model.cache_spec(batch_size,
                                                     max_seq).items():
            ax = axes[name]
            if ax.index("batch") != 1 or ax.index("kv_seq") != 2:
                raise NotImplementedError(
                    f"cache leaf {name!r} axes {ax}: the port pages only "
                    f"(layers, batch, kv_seq, ...) KV leaves")
            self.leaf_specs[name] = (shape, dtype)
            per_tok = 1
            for d in shape[:1] + shape[3:]:
                per_tok *= d
            self.compute_token_bytes += per_tok * dtype.itemsize
            if self.quantized:
                self.token_bytes += per_tok * self.store_dtype.itemsize
                # one f32 per (layer, kv head): the block's token and
                # head-dim axes are reduced.
                self.scale_bytes_per_block += (
                    shape[0] * kvquant.scale_bytes_per_block(shape[3]))
            else:
                self.token_bytes += per_tok * dtype.itemsize

    def init_pool(self, device) -> dict:
        """Zeroed pool leaves (L, pool_rows, T, KV, dh) in the stored
        dtype."""
        return {name: torch.zeros(
                    (shape[0], self.pool_rows, self.T) + tuple(shape[3:]),
                    dtype=self.store_dtype if self.quantized else dtype,
                    device=device)
                for name, (shape, dtype) in self.leaf_specs.items()}

    def init_scales(self, device) -> dict:
        """Zeroed scale leaves (L, pool_rows, KV) f32 of a narrow pool: an
        unwritten block dequantizes to exactly 0, like the zeroed bf16
        pool."""
        return {name: torch.zeros((shape[0], self.pool_rows, shape[3]),
                                  dtype=torch.float32, device=device)
                for name, (shape, _) in self.leaf_specs.items()}

    @property
    def geometry(self) -> dict:
        """Pool geometry; ``pool_bytes`` counts the stored block rows
        plus their scales."""
        pool_bytes = self.pool_rows * (self.T * self.token_bytes
                                       + self.scale_bytes_per_block)
        return {"block_size": self.T, "blocks_per_seq": self.nb,
                "pool_rows": self.pool_rows, "batch": self.B,
                "max_seq": self.max_seq, "token_bytes": self.token_bytes,
                "kv_dtype": self.kv_dtype,
                "scale_bytes_per_block": self.scale_bytes_per_block,
                "pool_bytes": pool_bytes, "pool_mb": pool_bytes / 2**20}

    def gather_bytes_per_tick(self) -> int:
        """KV bytes the GATHER step moves per decode tick: the pool read
        in its stored dtype (plus scales), the dense compute-dtype view
        written then read again by dense attention, and one block per
        slot quantized and scattered back — O(B * max_seq) however short
        the live requests."""
        pool_read = self.B * self.nb * (self.T * self.token_bytes
                                        + self.scale_bytes_per_block)
        dense = self.B * self.nb * self.T * self.compute_token_bytes
        writeback = self.B * (self.T * self.token_bytes
                              + self.scale_bytes_per_block)
        return pool_read + 2 * dense + writeback

    def kernel_bytes_per_tick(self, lengths) -> int:
        """KV bytes the KERNEL step touches for per-slot valid lengths:
        the blocks each slot's table references (in the stored dtype,
        with their scales), plus the per-slot append — one position for
        bf16; for a narrow pool the re-quantized active block is read and
        written whole, with its scale."""
        lengths = [int(x) for x in lengths]
        blocks = sum(blocks_for(x, self.T) for x in lengths)
        row = self.T * self.token_bytes + self.scale_bytes_per_block
        if self.quantized:
            return blocks * row + len(lengths) * 2 * row
        return (blocks * self.T + len(lengths)) * self.token_bytes

    def gather(self, pool, tables, scales=None) -> dict:
        """Pool leaves + tables (Bv, nb) -> dense view (L, Bv, nb*T, ...)
        (a fresh tensor: writes to it do not reach the pool).  With
        ``scales`` (a narrow pool) each gathered block is dequantized to
        the cache's compute dtype at ``kvquant.dequantize``'s rounding
        site."""
        Bv = tables.shape[0]
        flat = tables.reshape(-1).long()
        out = {}
        for name, leaf in pool.items():
            g = kvquant.as_bytes(leaf).index_select(1, flat)
            if scales is not None:
                s = scales[name].index_select(1, flat)    # (L, Bv*nb, KV)
                g = kvquant.dequantize(g.view(leaf.dtype),
                                       s[:, :, None, :, None],
                                       self.leaf_specs[name][1])
            out[name] = g.reshape(g.shape[0], Bv, self.nb * self.T,
                                  *g.shape[3:])
        return out

    def _store(self, leaf, sleaf, rows, blocks, valid):
        """Write ``blocks`` (L, N, T, ...) into pool rows ``rows`` (N,) in
        place; a narrow pool first zeroes positions outside ``valid``
        (N, T) (if given), re-derives each block's scale and quantizes."""
        if sleaf is None:
            leaf[:, rows] = blocks
            return
        if valid is not None:
            blocks = torch.where(valid[None, :, :, None, None], blocks, 0)
        s = kvquant.block_scale(blocks, (2, 4), self.kv_dtype)
        kvquant.as_bytes(leaf)[:, rows] = kvquant.as_bytes(
            kvquant.quantize(blocks, s, self.kv_dtype))
        sleaf[:, rows] = s[:, :, 0, :, 0]

    def scatter(self, pool, tables, dense, positions, scales=None) -> dict:
        """Write back, in place, the ONE block each slot touched this
        tick (logical block ``positions[b] // T``).  Inactive slots point
        at the NULL block, which absorbs their garbage.  A narrow pool
        (``scales`` given) zeroes positions past ``positions[b]``, so
        not-yet-written garbage never inflates the absmax, re-derives the
        block's scale and quantizes; bf16 pools write the gathered bits
        back unmasked."""
        B = tables.shape[0]
        b_idx = torch.arange(B, device=tables.device)
        jb = positions.long() // self.T
        pb = tables[b_idx, jb].long()
        seq = jb[:, None] * self.T + torch.arange(self.T,
                                                  device=tables.device)
        valid = seq <= positions.long()[:, None]                 # (B, T)
        sl = dict.fromkeys(pool) if scales is None else scales
        for name, leaf in pool.items():
            d = dense[name]
            blocks = d.reshape(d.shape[0], B, self.nb, self.T, *d.shape[3:])
            self._store(leaf, sl[name], pb, blocks[:, b_idx, jb], valid)
        return pool

    def scatter_view(self, pool, tables, dense, scales=None,
                     lengths=None) -> dict:
        """Write back, in place, EVERY block of the slots' dense views
        (L, Bv, nb*T, ...) — the counterpart of :meth:`scatter` for the
        gather prefill and verify steps, whose windows span several
        blocks.  Untouched blocks rewrite the values just gathered from
        them; NULL table entries (a padded tail, a window past the
        reservation) write into the NULL row, which is garbage by
        design, so repeated writes there are harmless.  A narrow pool
        quantizes each block with a fresh absmax scale, positions at or
        past each slot's ``lengths`` (Bv,) zeroed first when given."""
        Bv = tables.shape[0]
        flat = tables.reshape(-1).long()
        valid = None
        if scales is not None and lengths is not None:
            S = self.nb * self.T
            valid = (torch.arange(S, device=tables.device)[None]
                     < lengths.to(tables.device)[:, None]).reshape(
                         Bv * self.nb, self.T)
        sl = dict.fromkeys(pool) if scales is None else scales
        for name, leaf in pool.items():
            d = dense[name]
            self._store(leaf, sl[name], flat,
                        d.reshape(d.shape[0], Bv * self.nb, self.T,
                                  *d.shape[3:]), valid)
        return pool


class PagedCacheManager(PagedAllocator):
    """Block-pooled drop-in for ``cache.CacheManager`` at O6.

    Same engine-facing surface — ``.cache`` (the pool leaves; for a
    narrow pool the bundle ``{"pool": leaves, "scale": scale leaves}``),
    ``reset_slots(indices, live)``, ``step_extras()`` — plus the
    allocator lifecycle the scheduler drives through its
    ``admission_gate`` / ``on_admit`` / ``on_retire`` hooks.  Admission
    reserves the request's whole span, so ``reset_slots`` has nothing to
    zero: stale block contents are masked, not cleared.
    """

    def __init__(self, model, batch_size: int, max_seq: int, *,
                 block_size: int = 16, pool_blocks: int = 0,
                 kv_dtype: str = "bf16"):
        super().__init__(batch_size, max_seq, block_size=block_size,
                         pool_blocks=pool_blocks)
        self.model = model
        self.kv_dtype = kv_dtype
        self.plan = BlockPagingPlan(model, batch_size, max_seq,
                                    self.block_size, self.pool_blocks,
                                    kv_dtype=kv_dtype)
        self.cache = self.plan.init_pool(model.device)
        if self.plan.quantized:
            self.cache = {"pool": self.cache,
                          "scale": self.plan.init_scales(model.device)}
        self._tables_dev = None     # cached device copy of the tables

    @property
    def geometry(self) -> dict:
        return dict(self.plan.geometry)

    def step_extras(self) -> tuple:
        """(tables,) as a CACHED device tensor: tables only change at
        admission, growth, retirement and compaction, which invalidate
        it, so steady-state decode ticks reuse one upload."""
        if self._tables_dev is None:
            self._tables_dev = torch.from_numpy(self.tables.copy()).to(
                self.model.device)
        return (self._tables_dev,)

    def admit_slot(self, i: int, req) -> None:
        super().admit_slot(i, req)
        self._tables_dev = None

    def grow_slot(self, i: int, total_tokens: int) -> int:
        added = super().grow_slot(i, total_tokens)
        if added:
            self._tables_dev = None
        return added

    def release_slot(self, i: int, req=None) -> None:
        super().release_slot(i, req)
        self._tables_dev = None

    def reset_slots(self, indices: list, live: list) -> None:
        """Nothing to zero: the admitted slots' tables were rebuilt by
        ``admit_slot`` and every stale position is masked."""
        del indices, live

    def insert_slot(self, i: int, state) -> None:
        """Install an externally prefilled batch-1 DENSE cache into slot
        ``i``'s pool blocks (the INSERT phase of prefill -> insert ->
        generate).  Each leaf's sequence axis is padded to the table
        horizon (nb*T), folded to (nb, T) and scattered through slot
        ``i``'s table — ``place``/``admit_slot`` rebuilt it before this
        runs, and NULL entries past the reservation absorb the padded
        tail into the write-garbage NULL row.  A narrow pool quantizes
        each folded block with a fresh absmax scale and installs the
        scale rows beside it (``engine.prefill`` zeroes its state past
        the prompt, so only the prompt's values set a scale)."""
        if state.keys() != self.plan.leaf_specs.keys():
            raise ValueError(f"prefill state leaves {sorted(state)} != "
                             f"pool leaves {sorted(self.plan.leaf_specs)}")
        nb, T = self.plan.nb, self.plan.T
        row = torch.from_numpy(self.tables[i].astype(np.int64)).to(
            self.model.device)
        pool, scales = split_cache(self.cache, self.plan.quantized)
        sl = dict.fromkeys(pool) if scales is None else scales
        for name, leaf in pool.items():
            st = state[name].select(1, 0)                 # (L, S, KV, dh)
            pad = nb * T - st.shape[1]
            if pad:
                st = torch.cat([st, st.new_zeros((st.shape[0], pad)
                                                 + st.shape[2:])], dim=1)
            self.plan._store(leaf, sl[name], row,
                             st.reshape((st.shape[0], nb, T) + st.shape[2:]),
                             None)
        self._tables_dev = None

    def compact(self) -> None:
        """Copy-on-admit defrag: relocate every held block to the lowest
        ids, physically copying pool rows (and a narrow pool's scale
        rows) and rewriting the tables.  Optional — block ids are fully
        virtualized, so correctness never needs it; it keeps the live set
        a dense prefix of the pool."""
        held = sorted({b for row, n in zip(self.tables, self._held)
                       for b in row[:n].tolist()})
        moves = {old: new for new, old in enumerate(held, start=1)
                 if old != new}
        if not moves:
            return
        dev = self.model.device
        src = torch.tensor(list(moves), dtype=torch.long, device=dev)
        dst = torch.tensor(list(moves.values()), dtype=torch.long,
                           device=dev)
        pool, scales = split_cache(self.cache, self.plan.quantized)
        leaves = list(pool.values())
        if scales is not None:
            leaves += list(scales.values())
        for leaf in leaves:
            b = kvquant.as_bytes(leaf)
            b[:, dst] = b[:, src]         # the read is a copy: overlap-safe
        remap = np.arange(self.pool_blocks + 1, dtype=np.int32)
        remap[list(moves)] = list(moves.values())
        self.tables = remap[self.tables]
        self.allocator.rebuild(len(held))
        self._tables_dev = None
