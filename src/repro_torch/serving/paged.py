"""Paged decode-cache scratchpad — the serving ladder's O6 rung (port of
``repro/serving/paged.py``: the block allocator, the block tables, the
block paging plan, the state-row pool and the manager, on bf16 pools and
on narrow int8 / fp8 pools with one f32 scale per (block row, kv
head)).

Every KV leaf is stored as a pool of fixed-size blocks, and each slot
owns a block table mapping logical block ``j`` (positions ``j*T ..
j*T+T-1``) to a physical pool row.  Capacity is the pool over the actual
per-request reservations (``min(n_prompt + max_new_tokens, max_seq)``),
so short requests admit more concurrency at equal memory.

Recurrent state (the rwkv6 wkv matrix and token shifts, the mamba2
conv/ssm state) has no sequence axis: it is O(1) per slot, so blocks are
the wrong shape for it.  Those leaves live in a pool of per-slot state
ROWS instead, with a slot -> row map and no tables.  So does an enc-dec
family's cross-attention K/V (whisper): a fixed-length blob written once
at insert and read unmasked, so the stale-positions-are-masked argument
that makes paging safe does not hold for it.  Its axes say so: its
sequence axis is the encoder's ``enc_seq``, not ``kv_seq``.

Layering (the allocators are pure host code, testable without a device):

  * :class:`BlockAllocator` — free-list arithmetic over integer block
    ids.  Block 0 is the NULL block: unallocated table entries point at
    it, it is never handed out, its contents are write-garbage.
  * :class:`PagedAllocator` — per-slot block tables + reservation-based
    admission; drives the scheduler's admission gate (a request that fits
    ``max_seq`` but not the free blocks QUEUES, never raises).
  * :class:`StatePool` — the state-row sibling of the allocator: a
    slot -> row map and a row free list, row 0 the NULL row (never handed
    out; parked and unoccupied slots alias it, its contents are
    write-garbage).
  * :class:`BlockPagingPlan` — the tensor layer: pool leaves
    (L, R, T, KV, dh) in the stored dtype and, for narrow pools, scale
    leaves (L, R, KV) f32; the per-tick gather (pool -> dense per-slot
    view, dequantized), the single-block scatter of the gather decode
    step and the whole-view scatter of the gather prefill / verify steps
    (re-quantized), geometry and bytes.
  * :class:`StatePagingPlan` — the tensor layer of the state leaves:
    pooled (L, rows, ...) storage, the row gather and scatter, bytes
    per row.  State is never quantized.
  * :class:`PagedCacheManager` — the pools, tables and row map behind
    the contiguous manager's engine-facing surface, plus the INSERT of a
    prefilled dense state and the copy-on-admit defrag ``compact``.

Token identity with the contiguous path rests on one invariant: a slot
at position ``p`` has itself written every position ``< p`` (its blocks
are reserved up front), position ``p`` is written before attention reads
it, and every position ``> p`` is masked before the softmax.  A state
row is carried, not masked, so the manager zeroes a row when it is
assigned and parks a slot mid-prompt on the NULL row.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.scan_prefill import gather_rows, scatter_rows
from repro_torch.serving import kvquant

NULL_BLOCK = 0
NULL_ROW = 0


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` positions."""
    return -(-max(n_tokens, 0) // block_size)


def is_state_leaf(axes: tuple) -> bool:
    """A cache leaf with no ``kv_seq`` axis is state (row-pooled): carried
    state, or an encoder's read-only K/V; one with a ``kv_seq`` axis is a
    KV log (block-pooled)."""
    return "kv_seq" not in axes


def is_read_only_leaf(axes: tuple) -> bool:
    """A state leaf over the encoder's sequence (``enc_seq``: an enc-dec
    family's cross K/V) is written once, at insert, and by no step."""
    return "enc_seq" in axes


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


class StatePool:
    """Slot -> state-row indirection for O(1)-per-slot cache leaves: a
    numpy row map and a python free list (pure host code, like
    :class:`PagedAllocator`).  Row 0 is the NULL row — never handed out,
    aliased by parked and unoccupied slots, its contents write-garbage.

    ``n_rows`` allocatable rows, one per engine slot; physical storage
    has ``n_rows + 1``.  A slot holds exactly ONE row from admission to
    retirement — recurrent state does not grow — so admission is one pop
    and there is no reservation arithmetic."""

    def __init__(self, batch_size: int):
        self.B = self.n_rows = batch_size
        # rows[i] = physical state row of slot i (NULL_ROW = unoccupied)
        self.rows = np.full((batch_size,), NULL_ROW, np.int32)
        self._free = list(range(self.n_rows, 0, -1))   # pop() -> lowest id

    @property
    def free_rows(self) -> int:
        return len(self._free)

    @property
    def used_rows(self) -> int:
        return self.n_rows - len(self._free)

    def can_admit(self, req=None) -> bool:
        return bool(self._free)

    def admit_slot(self, i: int, req=None) -> None:
        if self.rows[i] != NULL_ROW:
            raise RuntimeError(f"slot {i} admitted while holding row "
                               f"{int(self.rows[i])}")
        if not self._free:
            raise RuntimeError(
                "state pool exhausted (admission gate should have queued)")
        self.rows[i] = self._free.pop()

    def release_slot(self, i: int, req=None) -> None:
        r = int(self.rows[i])
        if r == NULL_ROW:
            return                       # releasing an empty slot: no-op
        if r in self._free or not (1 <= r <= self.n_rows):
            raise RuntimeError(f"double/invalid free of state row {r}")
        self.rows[i] = NULL_ROW
        self._free.append(r)

    def compaction_moves(self) -> dict:
        """{old_row: new_row} packing the held rows into the lowest ids
        in slot order (the manager copies the rows, then calls
        :meth:`apply_moves`)."""
        held = [int(r) for r in self.rows if r != NULL_ROW]
        return {old: new for old, new in zip(held, range(1, len(held) + 1))
                if old != new}

    def apply_moves(self, moves: dict) -> None:
        self.rows = np.array([moves.get(int(r), int(r)) for r in self.rows],
                             np.int32)
        held = {int(r) for r in self.rows if r != NULL_ROW}
        self._free = [r for r in range(self.n_rows, 0, -1) if r not in held]

    def check_conservation(self) -> None:
        """held + free == total, and no row is in two places."""
        held = [int(r) for r in self.rows if r != NULL_ROW]
        free = self._free
        if len(set(held)) != len(held):
            raise AssertionError(f"state row held twice: {held}")
        if len(held) + len(free) != self.n_rows:
            raise AssertionError(f"rows not conserved: held {held}, "
                                 f"free {free}")
        if set(held) & set(free):
            raise AssertionError("row both held and free")
        if not all(1 <= r <= self.n_rows for r in held):
            raise AssertionError(f"row out of range: {held}")


class BlockPagingPlan:
    """Pool layout of the KV leaves (the dense family's; a recurrent
    family has none, its state leaves belong to :class:`StatePagingPlan`).

    Every KV leaf ``(L, B, S, KV, dh)`` (batch at axis 1, sequence
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
            if is_state_leaf(ax):
                continue
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
        for name in self.leaf_specs:
            leaf = pool[name]
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
        sl = dict.fromkeys(self.leaf_specs) if scales is None else scales
        for name in self.leaf_specs:
            d = dense[name]
            blocks = d.reshape(d.shape[0], B, self.nb, self.T, *d.shape[3:])
            self._store(pool[name], sl[name], pb, blocks[:, b_idx, jb],
                        valid)
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
        sl = dict.fromkeys(self.leaf_specs) if scales is None else scales
        for name in self.leaf_specs:
            d = dense[name]
            self._store(pool[name], sl[name], flat,
                        d.reshape(d.shape[0], Bv * self.nb, self.T,
                                  *d.shape[3:]), valid)
        return pool


class StatePagingPlan:
    """Row-pooled storage of the state leaves (the recurrent families'
    carried state, an enc-dec family's read-only cross K/V).

    Each state leaf trades its batch axis for a pool-row axis of
    ``total_rows`` rows (``rows``' allocatable rows + the NULL row 0) at
    the same position (``cache_axes``' "batch").  :meth:`gather` takes
    each slot's row out into a dense batch view, :meth:`scatter` writes
    the view back through the rows in place; the NULL row takes the
    writes of parked and unoccupied slots, however many alias it
    (``models/scan_prefill``'s row helpers, which the paged kernel step
    uses too).  A read-only leaf (cross K/V) is gathered but never
    scattered back: no step writes it.  State is never quantized: it is
    carried or read unmasked, and the narrow pools' tolerance contract
    covers masked attention reads only."""

    def __init__(self, model, rows: StatePool, max_seq: int):
        self.total_rows = rows.n_rows + 1
        axes = model.cache_axes()
        self.leaf_specs = {}          # name -> (shape, dtype, batch axis)
        self.batch_axes = {}          # name -> batch axis
        self.carried_axes = {}        # the same, read-only leaves left out
        self.state_row_bytes = 0
        for name, (shape, dtype) in model.cache_spec(rows.B,
                                                     max_seq).items():
            if not is_state_leaf(axes[name]):
                continue
            bax = axes[name].index("batch")
            self.leaf_specs[name] = (shape, dtype, bax)
            self.batch_axes[name] = bax
            if not is_read_only_leaf(axes[name]):
                self.carried_axes[name] = bax
            n = 1
            for ax, d in enumerate(shape):
                if ax != bax:
                    n *= d
            self.state_row_bytes += n * dtype.itemsize

    @property
    def geometry(self) -> dict:
        return {"state_rows": self.total_rows,
                "state_row_bytes": self.state_row_bytes,
                "state_bytes": self.total_rows * self.state_row_bytes}

    def init_pool(self, device) -> dict:
        """Zeroed pooled leaves: each state leaf with ``total_rows`` at its
        batch axis."""
        out = {}
        for name, (shape, dtype, bax) in self.leaf_specs.items():
            pooled = list(shape)
            pooled[bax] = self.total_rows
            out[name] = torch.zeros(pooled, dtype=dtype, device=device)
        return out

    def gather(self, pool, rows) -> dict:
        """Pooled state leaves + rows (Bv,) -> dense per-slot view
        (``scan_prefill.gather_rows``)."""
        return gather_rows(pool, rows, self.batch_axes)

    def scatter(self, pool, rows, dense) -> dict:
        """The view's carried leaves back into their pool rows in place,
        the NULL row the sink (``scan_prefill.scatter_rows``); read-only
        leaves are not written."""
        return scatter_rows(pool, rows, dense, self.carried_axes)

    def zero_rows(self, pool, rows) -> None:
        """Zero pool rows ``rows`` (a long tensor) of every state leaf:
        one fill per leaf."""
        for name, (_, _, bax) in self.leaf_specs.items():
            pool[name].index_fill_(bax, rows, 0)

    def move_rows(self, pool, src, dst) -> None:
        """Copy pool rows ``src`` onto rows ``dst`` (long tensors) of
        every state leaf; the read is a copy, so overlap is safe."""
        for name, (_, _, bax) in self.leaf_specs.items():
            leaf = pool[name]
            leaf.index_copy_(bax, dst, leaf.index_select(bax, src))


class PagedCacheManager(PagedAllocator):
    """Pooled drop-in for ``cache.CacheManager`` at O6.

    Same engine-facing surface — ``.cache`` (the pool leaves; for a
    narrow pool the bundle ``{"pool": leaves, "scale": scale leaves}``),
    ``reset_slots(indices, live)``, ``step_extras()`` — plus the
    allocator lifecycle the scheduler drives through its
    ``admission_gate`` / ``on_admit`` / ``on_retire`` hooks.

    KV leaves live in blocks: admission reserves the request's whole
    span, and stale block contents are masked, not cleared.  State leaves
    (a recurrent family's carry) live in a :class:`StatePool` of rows:
    admission takes one row per slot (a pure-state family reserves no
    blocks at all), retirement returns it, ``reset_slots`` zeroes the
    freshly assigned rows (state is carried, not masked), and
    ``insert_slot`` / ``compact`` move state through the row map.
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
        self.has_blocks = bool(self.plan.leaf_specs)
        self.state = self.state_plan = None
        rows = StatePool(batch_size)
        splan = StatePagingPlan(model, rows, max_seq)
        pool = self.plan.init_pool(model.device)
        if splan.leaf_specs:
            self.state, self.state_plan = rows, splan
            pool.update(splan.init_pool(model.device))
        self.cache = pool
        if self.plan.quantized:
            self.cache = {"pool": pool,
                          "scale": self.plan.init_scales(model.device)}
        self._tables_dev = None     # cached device copy of the tables
        self._rows_dev = None       # cached device copy of the row map

    @property
    def geometry(self) -> dict:
        """The block plan's geometry plus the state-row pool's
        (``state_rows``, ``state_row_bytes``, ``state_bytes``; zeros for a
        family without state leaves); ``pool_bytes`` counts both."""
        g = dict(self.plan.geometry)
        if self.state_plan is None:
            g.update(state_rows=0, state_row_bytes=0, state_bytes=0)
        else:
            g.update(self.state_plan.geometry)
            g["pool_bytes"] += g["state_bytes"]
            g["pool_mb"] = g["pool_bytes"] / 2**20
        return g

    def step_extras(self, parked=None) -> tuple:
        """The block tables (iff the family has KV leaves), then the state
        rows (iff it has state leaves), as CACHED device tensors: they
        change only at admission, growth, retirement and compaction, which
        invalidate them, so steady-state decode ticks reuse one upload.

        ``parked``: slots whose state row is aliased to the NULL row for
        THIS tick — the chunked-prefill park.  A parked slot's batched
        decode reads NULL garbage (its output is discarded; batch rows
        are independent) and its write lands in the sink, so its real
        state advances only through its prefill chunks.  A pure-KV
        family's tables are not aliased: a parked slot's KV write is the
        right value at its next prompt position, which its next chunk
        rewrites.  A mixed pool (state AND blocks) aliases the parked
        slots' whole table rows to the NULL block as well: their K/V is
        computed from the NULL row's garbage state, and on a narrow pool
        the append would re-quantize the slot's active block, whose
        earlier positions its chunks already wrote.  An enc-dec family's
        parked slot reads the NULL row's cross K/V the same way; its own
        cross row is read-only and keeps its bits."""
        dev = self.model.device
        out = []
        if self.has_blocks:
            if parked and self.state is not None:
                tables = self.tables.copy()
                tables[list(parked)] = NULL_BLOCK
                out.append(torch.from_numpy(tables).to(dev))
            else:
                if self._tables_dev is None:
                    self._tables_dev = torch.from_numpy(
                        self.tables.copy()).to(dev)
                out.append(self._tables_dev)
        if self.state is not None:
            if parked:
                rows = self.state.rows.copy()
                rows[list(parked)] = NULL_ROW
                out.append(torch.from_numpy(rows).to(dev))
            else:
                if self._rows_dev is None:
                    self._rows_dev = torch.from_numpy(
                        self.state.rows.copy()).to(dev)
                out.append(self._rows_dev)
        return tuple(out)

    # -- admission: both pools must say yes ----------------------------------
    def blocks_needed(self, req) -> int:
        return super().blocks_needed(req) if self.has_blocks else 0

    def can_admit(self, req) -> bool:
        if self.has_blocks and not super().can_admit(req):
            return False
        return self.state is None or self.state.can_admit(req)

    def admit_slot(self, i: int, req) -> None:
        if self.has_blocks:
            super().admit_slot(i, req)
            self._tables_dev = None
        if self.state is not None:
            self.state.admit_slot(i, req)
            self._rows_dev = None

    def grow_slot(self, i: int, total_tokens: int) -> int:
        added = super().grow_slot(i, total_tokens)
        if added:
            self._tables_dev = None
        return added

    def release_slot(self, i: int, req=None) -> None:
        if self.has_blocks:
            super().release_slot(i, req)
            self._tables_dev = None
        if self.state is not None:
            self.state.release_slot(i, req)
            self._rows_dev = None

    def check_conservation(self) -> None:
        if self.has_blocks:
            super().check_conservation()
        if self.state is not None:
            self.state.check_conservation()

    def reset_slots(self, indices: list, live: list) -> None:
        """Zero the state rows ``admit_slot`` just assigned to ``indices``
        (one fill per state leaf): state is carried, not masked, so a
        previous tenant's would leak into the new request's first step;
        a cross row read unmasked would too, so a submitted enc-dec
        request starts from the zero cross K/V the reference serves with
        (``insert_slot`` puts an encoded one in).  KV blocks need
        nothing — their tables were rebuilt and every stale position is
        masked."""
        del live
        if not indices or self.state is None:
            return
        rows = torch.tensor([int(self.state.rows[i]) for i in indices],
                            dtype=torch.long, device=self.model.device)
        pool, _ = split_cache(self.cache, self.plan.quantized)
        self.state_plan.zero_rows(pool, rows)

    def insert_slot(self, i: int, state) -> None:
        """Install an externally prefilled batch-1 DENSE cache into slot
        ``i`` (the INSERT phase of prefill -> insert -> generate).  A KV
        leaf's sequence axis is padded to the table horizon (nb*T),
        folded to (nb, T) and scattered through slot ``i``'s table —
        ``place``/``admit_slot`` rebuilt it before this runs, and NULL
        entries past the reservation absorb the padded tail into the
        write-garbage NULL row.  A narrow pool quantizes each folded
        block with a fresh absmax scale and installs the scale rows
        beside it (``engine.prefill`` zeroes its state past the prompt,
        so only the prompt's values set a scale).  A state leaf's batch-1
        slice is copied into slot ``i``'s state row — cross-attention K/V
        built offline (``encdec.build_cross_cache``) rides in through the
        same door."""
        pool, scales = split_cache(self.cache, self.plan.quantized)
        if state.keys() != pool.keys():
            raise ValueError(f"prefill state leaves {sorted(state)} != "
                             f"pool leaves {sorted(pool)}")
        nb, T = self.plan.nb, self.plan.T
        row = torch.from_numpy(self.tables[i].astype(np.int64)).to(
            self.model.device)
        sl = dict.fromkeys(self.plan.leaf_specs) if scales is None else scales
        for name in self.plan.leaf_specs:
            st = state[name].select(1, 0)                 # (L, S, KV, dh)
            pad = nb * T - st.shape[1]
            if pad:
                st = torch.cat([st, st.new_zeros((st.shape[0], pad)
                                                 + st.shape[2:])], dim=1)
            self.plan._store(pool[name], sl[name], row,
                             st.reshape((st.shape[0], nb, T) + st.shape[2:]),
                             None)
        if self.state is not None:
            r = int(self.state.rows[i])
            for name, (_, _, bax) in self.state_plan.leaf_specs.items():
                pool[name].select(bax, r).copy_(state[name].select(bax, 0))
        self._tables_dev = None

    def compact(self) -> None:
        """Copy-on-admit defrag: relocate every held block to the lowest
        ids, physically copying pool rows (and a narrow pool's scale
        rows) and rewriting the tables, and pack the held state rows into
        the lowest row ids in slot order.  Optional — ids are fully
        virtualized, so correctness never needs it; it keeps the live set
        a dense prefix of each pool."""
        dev = self.model.device
        pool, scales = split_cache(self.cache, self.plan.quantized)
        held = sorted({b for row, n in zip(self.tables, self._held)
                       for b in row[:n].tolist()})
        moves = {old: new for new, old in enumerate(held, start=1)
                 if old != new}
        if moves:
            src = torch.tensor(list(moves), dtype=torch.long, device=dev)
            dst = torch.tensor(list(moves.values()), dtype=torch.long,
                               device=dev)
            leaves = [pool[name] for name in self.plan.leaf_specs]
            if scales is not None:
                leaves += list(scales.values())
            for leaf in leaves:
                b = kvquant.as_bytes(leaf)
                b[:, dst] = b[:, src]     # the read is a copy: overlap-safe
            remap = np.arange(self.pool_blocks + 1, dtype=np.int32)
            remap[list(moves)] = list(moves.values())
            self.tables = remap[self.tables]
            self.allocator.rebuild(len(held))
            self._tables_dev = None
        smoves = (self.state.compaction_moves()
                  if self.state is not None else {})
        if smoves:
            self.state_plan.move_rows(
                pool, torch.tensor(list(smoves), dtype=torch.long,
                                   device=dev),
                torch.tensor(list(smoves.values()), dtype=torch.long,
                             device=dev))
            self.state.apply_moves(smoves)
            self._rows_dev = None
