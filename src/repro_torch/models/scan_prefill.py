"""Chunked prefill for carried-state decoders, by running the decode
body over the chunk (port of ``repro/models/scan_prefill.py``).

A transformer chunks prefill by batching C prompt tokens into one wide
attention call: its KV cache is position-addressed, so a padded tail's
writes land at positions that are rewritten before they are read.  A
recurrent family (rwkv6, mamba2, the hybrid zamba2's trunk) cannot: its
state is carried, so a pad token fed to a slot would fold into the carry
for good.

Here a chunk runs the family's exact single-token decode body over its C
positions, in a Python loop (the reference's ``lax.scan``), and FREEZES
each slot's cache leaves once the loop passes that slot's last real
token: a ``torch.where`` on the batch axis keeps the old value for
``j > last``.  The result is bit-identical to C one-token decode steps
by construction (same body, same order, same dtypes).  The body still
runs C times: a chunk saves scheduler ticks and dispatches, not FLOPs.

A family that also holds position-addressed KV leaves (the hybrid's
shared attention) names them ``in_place``: the body appends to them in
place, for the live slots only, instead of returning fresh copies (a
fresh KV leaf a token would cost the whole cache a token).  A frozen
slot's KV positions keep their bits, as the reference's ``where`` keeps
them, and ``max_seq`` clips the positions a padded tail feeds, as the
reference does, so they stay inside the leaf.

The row helpers (``gather_rows``, ``scatter_rows``, ``row_decode_step``)
hold the one layout of a state-row pool: each state leaf with a pool-row
axis at its batch axis, row 0 the NULL row.  The paged kernel step of
both families and ``serving/paged.StatePagingPlan`` go through them.
"""

from __future__ import annotations

import torch


def batch_axes_of(axes_tree: dict) -> dict:
    """Batch-axis index of every cache leaf, by leaf name."""
    return {name: ax.index("batch") for name, ax in axes_tree.items()}


def gather_rows(pool: dict, rows, batch_axes: dict) -> dict:
    """Pooled state leaves + rows (B,) -> the dense per-slot view (fresh
    tensors: writes to them do not reach the pool)."""
    idx = rows.long()
    return {name: pool[name].index_select(bax, idx)
            for name, bax in batch_axes.items()}


def scatter_rows(pool: dict, rows, dense: dict, batch_axes: dict) -> dict:
    """Write each slot's dense state back into its pool row, in place.
    Slots on the NULL row (parked mid-prefill, unoccupied) all land in
    row 0, the write-garbage sink, so their carried state is exactly not
    advanced."""
    idx = rows.long()
    for name, bax in batch_axes.items():
        leaf = pool[name]
        leaf.index_copy_(bax, idx, dense[name].to(leaf.dtype))
    return pool


def row_decode_step(decode_fn, pool: dict, rows, tokens, positions, *,
                    batch_axes: dict):
    """The state-pool decode step (serving O6): gather the slots' rows,
    run ``decode_fn(cache, tokens, positions) -> (logits, cache)`` on the
    dense view, scatter it back through the same rows.  Slots parked on
    the NULL row read garbage (their logits are discarded).  Returns
    (logits, pool)."""
    logits, dense = decode_fn(gather_rows(pool, rows, batch_axes), tokens,
                              positions)
    return logits, scatter_rows(pool, rows, dense, batch_axes)


def scan_prefill(decode_fn, cache: dict, tokens, start, last, *,
                 logits_width: int, batch_axes: dict, max_seq=None,
                 in_place=()):
    """Run ``decode_fn`` over a prompt chunk, one token at a time.

    ``decode_fn(cache, tok (B, 1), pos (B,)) -> (logits (B, V), new
    cache)`` is the family's single-token decode body; it must leave its
    input leaves untouched and return fresh ones.  ``tokens`` (B, C)
    holds C consecutive prompt tokens per slot from position ``start``
    (B,); ``last`` (B,) is the row of each slot's final real token in
    this chunk (rows past it are pad).  Writes the chunk's state into
    ``cache`` in place and returns (logits (B, V) f32 taken at each
    slot's ``last`` row, cache).  A slot whose prompt ends mid-chunk
    keeps, on its batch row of every leaf, the value it had after its
    ``last`` token: pad feeds never touch carried state.

    ``max_seq`` clips each step's positions to ``[0, max_seq)``.  The
    leaves named in ``in_place`` are position-addressed logs (or
    read-only, as an enc-dec's cross K/V): the body is then called as
    ``decode_fn(cache, tok, pos, live)`` with ``live`` (B,) bool, must
    write those leaves in place on the live slots' rows only (or not at
    all), and returns them as they are; they are neither frozen nor
    copied here."""
    B, C = tokens.shape
    cur = dict(cache)
    sel = torch.zeros((B, logits_width), dtype=torch.float32,
                      device=tokens.device)
    last = last.to(tokens.device)
    for j in range(C):
        pos = start + j
        if max_seq is not None:
            pos = pos.clamp(0, max_seq - 1)
        live = j <= last                                          # (B,)
        if in_place:
            logits, new = decode_fn(cur, tokens[:, j:j + 1], pos, live)
        else:
            logits, new = decode_fn(cur, tokens[:, j:j + 1], pos)
        for name, old in cur.items():
            if name in in_place:
                continue
            bax = batch_axes[name]
            mask = live.reshape((1,) * bax + (B,)
                                + (1,) * (old.dim() - bax - 1))
            cur[name] = torch.where(mask, new[name].to(old.dtype), old)
        sel = torch.where((last == j)[:, None], logits, sel)
    for name, leaf in cache.items():
        if name not in in_place:
            leaf.copy_(cur[name])
    return sel, cache
