"""KVLayout: how the decode cache is stored (port of
``repro/serving/layout.py``).

The engine selects one strategy object and never branches on layout
again:

  * :class:`ContiguousLayout` — one ``batch x max_seq`` cache slice per
    slot (rungs O0..O5);
  * :class:`PagedLayout` — a pooled KV-block scratchpad with per-request
    block tables (O6).  ``paged_attn="gather"`` re-materializes each
    slot's dense view from the pool every tick, runs the SAME dense
    ``decode_step`` the contiguous rungs run and scatters back the one
    block it wrote; ``paged_attn="kernel"`` runs the model's
    ``paged_decode_step`` — the CUDA paged-decode kernel on the raw pool,
    no dense view at all.  ``attn_impl`` records what was built.  A
    recurrent family's carried state lives in a pool of state rows
    (``state_impl="rows"``): the gather step gathers the slots' rows, the
    kernel step hands the rows to the model's paged step, which does the
    same (rwkv6 and mamba2 have no attention to run a kernel on; the
    hybrid zamba2 takes its tables and rows both, and its shared
    attention runs the paged-decode kernel; so does the enc-dec whisper,
    whose state rows hold its read-only cross K/V and whose decoder
    self-attention runs the kernel).

The layout owns cache-manager construction, scheduler wiring (the block
pool's admission gates) and the three steps the engine dispatches: the
fused decode+sample step, the single-slot prefill-chunk step and the
batched speculative-verify step.  On the paged layout the kernel variant
of the last two runs the model's paged steps (the CUDA multi-query
kernel B2 on the raw pool) and the gather variant the dense steps on a
gathered view, scattered back whole (``scatter_view``).  The port runs
eagerly on one device, so a "step" is a plain function; placement is
the engine's single-device record.

A narrow pool (``kv_dtype`` "int8" / "fp8") travels as the manager's
``{"pool", "scale"}`` bundle, which every paged step splits and passes
on: the gather steps dequantize the gathered view and re-quantize what
they scatter back; the kernel steps hand the scales to the model's
paged steps, whose attention re-quantizes the blocks it writes and whose
kernels dequantize each block they stage.  The two paths differ on
narrow pools by design — the gather path attends the current token
unquantized, the kernel path reads it re-quantized — so each owes the
dtype's tolerance contract against the O5 tokens
(``kvquant.tolerance_contract``), not bit-identity with the other.
State rows are never quantized.

The contiguous layout cannot chunk a carried-state family's prefill: a
slot parked mid-prompt in the batched tick would fold its pad feed into
the carry, and there is no row map to park it through.  It degrades to
token-by-token prefill and records why in ``degrade_reason``; the paged
layout chunks these families by parking the slot on the NULL state row
(``PagedCacheManager.step_extras(parked=...)``).
"""

from __future__ import annotations

import dataclasses
import logging

import torch

from repro_torch.serving import kvquant
from repro_torch.serving.cache import CacheManager
from repro_torch.serving.paged import PagedCacheManager, split_cache
from repro_torch.serving.sampler import make_sampler

log = logging.getLogger(__name__)


def make_fused(model, sample):
    """The batched fused decode+sample step (contiguous O2+)."""
    def _fused(params, cache, tokens, positions, seeds):
        logits, new_cache = model.decode_step(params, cache, tokens,
                                              positions)
        return sample(logits, seeds), new_cache

    return _fused


def shared_steps(model, sampler_cfg) -> dict:
    """The contiguous layout's steps for ``model`` (the drafter's too):

    * ``fused`` — batched decode + sample (:func:`make_fused`);
    * ``single`` — one request's decode step, the un-pipelined O0/O1
      loop: ``(params, cache, token, position, islot) -> (logits (V,),
      cache)`` runs a batch-1 ``decode_step`` on slot ``islot``'s rows of
      the cache in place and returns that request's last logits, so each
      request pays its own pass over the weights;
    * ``prefill`` — one slot's prefill CHUNK: ``(params, cache, islot,
      tokens (1, C), start (1,), last (1,), seeds) -> (token, cache)``,
      run on slot ``islot``'s rows of the cache in place and sampled at
      row ``last`` (the chunk's final real token; only the final chunk's
      sample is used).  Chunks are padded to a fixed C: pad rows write at
      future or clipped positions that are rewritten before first read
      or masked, and their logits are never selected;
    * ``verify`` — speculative verify: ``(params, cache, tokens (B, C),
      start (B,)) -> (greedy tokens (B, C), cache)``, one batched forward
      over every slot's pending token + drafts, the greedy token at every
      row.  Built only for greedy samplers (the engine gates speculation
      on determinism), where ``sample`` reduces over the last axis row by
      row;
    * ``sample`` — the sampler alone, ``(logits (B, V), seeds) -> tokens
      (B,)``: at O0/O1 a stochastic kind samples each request's logits in
      a device call of its own."""
    sample = make_sampler(sampler_cfg)
    batch_axis = {name: ax.index("batch")
                  for name, ax in model.cache_axes().items()}

    def _row(cache, islot):
        """Slot ``islot``'s rows of every leaf, as views: in place."""
        return {name: leaf.narrow(batch_axis[name], islot, 1)
                for name, leaf in cache.items()}

    def _single(params, cache, token, position, islot):
        dev = model.device
        logits, _ = model.decode_step(params, _row(cache, islot),
                                      torch.tensor([[token]], device=dev),
                                      torch.tensor([position], device=dev))
        return logits[0], cache

    def _prefill(params, cache, islot, tokens, start, last, seeds):
        logits, _ = model.prefill_step(params, _row(cache, islot), tokens,
                                       start, last)
        return sample(logits, seeds)[0], cache

    def _verify(params, cache, tokens, start):
        logits, cache = model.verify_step(params, cache, tokens, start)
        return sample(logits, None), cache

    return {"fused": make_fused(model, sample), "single": _single,
            "prefill": _prefill, "verify": _verify, "sample": sample}


def _split_extras(manager, extras):
    """(tables, rows) of a paged step's extras, in the order the
    manager's ``step_extras()`` emits them: tables iff it has KV leaves,
    rows iff it has state leaves (``None`` for what it lacks)."""
    it = iter(extras)
    tables = next(it) if manager.has_blocks else None
    rows = next(it) if manager.state is not None else None
    return tables, rows


def _gather_view(manager, pool, scales, tables, rows) -> dict:
    """The dense view of the slots in ``tables`` / ``rows``: KV blocks
    through the tables (dequantized from a narrow pool), state through
    the rows."""
    dense = {}
    if tables is not None:
        dense.update(manager.plan.gather(pool, tables, scales))
    if rows is not None:
        dense.update(manager.state_plan.gather(pool, rows))
    return dense


def make_paged_fused(model, sample, manager):
    """The paged GATHER step: block-table gather (KV leaves) and row
    gather (state leaves) -> the SAME dense ``decode_step`` the
    contiguous rungs run -> row scatter and single-block scatter back
    into the pools (in place).  The dense view is identical to the
    contiguous cache at every unmasked position and the rows hold the
    exact carried state, so greedy tokens cannot drift from the
    contiguous path (a narrow pool: up to its dtype's tolerance
    contract)."""
    plan, splan = manager.plan, manager.state_plan

    def _fused(params, cache, *rest):
        extras, (tokens, positions, seeds) = rest[:-3], rest[-3:]
        tables, rows = _split_extras(manager, extras)
        pool, scales = split_cache(cache, plan.quantized)
        dense = _gather_view(manager, pool, scales, tables, rows)
        logits, dense = model.decode_step(params, dense, tokens, positions)
        toks = sample(logits, seeds)
        if rows is not None:
            splan.scatter(pool, rows, dense)
        if tables is not None:
            plan.scatter(pool, tables, dense, positions, scales)
        return toks, cache

    return _fused


def make_paged_kernel_fused(model, sample, manager):
    """The paged KERNEL step (``paged_attn="kernel"``): the model's
    ``paged_decode_step`` consumes the pool + the manager's extras
    (tables and/or state rows) + positions directly; each attention layer
    appends its token's K/V into the active block in place and the
    paged-decode kernel reads only the blocks each slot references."""
    quantized, kv_dtype = manager.plan.quantized, manager.kv_dtype

    def _fused(params, cache, *rest):
        extras, (tokens, positions, seeds) = rest[:-3], rest[-3:]
        pool, scales = split_cache(cache, quantized)
        logits = model.paged_decode_step(params, pool, *extras, tokens,
                                         positions, scales=scales,
                                         kv_dtype=kv_dtype)[0]
        return sample(logits, seeds), cache

    return _fused


class KVLayout:
    """Strategy protocol for the decode-cache layout.

    ``name``           — "contiguous" / "paged".
    ``build_manager``  — construct the cache manager.
    ``wire_scheduler`` — attach admission gate / lifecycle hooks.
    ``make_step``      — the fused decode+sample step
                         ``(params, cache, *extras, tokens, positions,
                         seeds) -> (tokens, cache)``; ``extras`` come from
                         the manager's ``step_extras()``.
    ``make_prefill_step`` — the single-slot prefill-chunk step
                         ``(params, cache, *extras, islot, tokens (1, C),
                         start (1,), last (1,), seeds) -> (token, cache)``,
                         or None when the model has no prefill step or
                         the layout cannot chunk its family (the engine
                         then feeds prompts one token per tick).
    ``make_verify_step`` — the speculative-verify step ``(params, cache,
                         *extras, tokens (B, C), start (B,)) -> (greedy
                         tokens (B, C), cache)``, or None when the model
                         has no verify step (the engine then decodes
                         plainly).
    ``make_solo_prefill`` — a standalone batch-1 cache of this layout and
                         the layout's own prefill-chunk step on it, for
                         ``DecodeEngine.prefill``: ``(cache, step, dense)``
                         with ``step(params, cache, tokens (1, C), start
                         (1,), last (1,), seeds) -> (token, cache)`` and
                         ``dense(cache)`` the state as a batch-1 dense
                         cache, so a prefilled request's state and first
                         token are those its admission would compute.
    ``attn_impl``      — the attention implementation the built steps use
                         ("gather"/"kernel"; None on the contiguous layout).
    ``state_impl``     — how carried state moves: "rows" when the family's
                         state leaves live in the paged row pool, else
                         "none".
    ``degrade_reason`` — why a requested capability fell back (chunked
                         prefill of a carried-state family on the
                         contiguous layout), or None.
    """

    name: str = "?"
    attn_impl = None
    state_impl = "none"
    degrade_reason = None

    def build_manager(self, model, batch_size, max_seq, config):
        raise NotImplementedError

    def wire_scheduler(self, scheduler, manager) -> None:
        pass

    def make_step(self, model, sampler_cfg, manager):
        raise NotImplementedError


class ContiguousLayout(KVLayout):
    """One ``batch x max_seq`` cache slice per slot (rungs O0..O5)."""

    name = "contiguous"

    def build_manager(self, model, batch_size, max_seq, config):
        return CacheManager(model, batch_size, max_seq, config.level)

    def make_step(self, model, sampler_cfg, manager):
        return make_fused(model, make_sampler(sampler_cfg))

    def make_prefill_step(self, model, sampler_cfg, manager):
        if model.prefill_step is None:
            return None
        if model.carries_state:
            # A chunking engine parks mid-prompt slots inside the batched
            # tick by feeding them their next prompt token: a KV write is
            # rewritten by the next chunk, but a carried state would
            # advance twice, and this layout has no row map to park the
            # slot through.
            self.degrade_reason = (
                f"prefill_chunk requested but family "
                f"'{model.cfg.family}' carries recurrent state, which the "
                f"contiguous layout cannot park mid-prompt; degraded to "
                f"token-by-token prefill (the paged layout (level>=6) "
                f"chunks this family via NULL-row parking)")
            log.warning("%s", self.degrade_reason)
            return None
        return shared_steps(model, sampler_cfg)["prefill"]

    def make_verify_step(self, model, sampler_cfg, manager):
        if model.verify_step is None:
            return None
        return shared_steps(model, sampler_cfg)["verify"]

    def make_solo_prefill(self, model, sampler_cfg, max_seq, config):
        step = shared_steps(model, sampler_cfg)["prefill"]
        return (model.init_cache(1, max_seq),
                lambda params, cache, *args: step(params, cache, 0, *args),
                lambda cache: cache)


class PagedLayout(KVLayout):
    """Pooled KV-block scratchpad with per-request block tables (O6).

    ``paged_attn`` selects the steps' attention implementation and is
    recorded as ``attn_impl``.  The dense family has paged decode,
    prefill and verify steps; the recurrent families have a paged decode
    step over state rows and no attention, so their prefill chunk is the
    row-gather step under either ``paged_attn`` (``prefill_impl`` records
    which prefill was built) and they have no verify step.  ``kv_dtype``
    is the pool's stored dtype: "bf16" (bit-identical ladder), or "int8"
    / "fp8" words with per-block scales, whose rung owes the dtype's
    tolerance contract (``serving.kvquant.tolerance_contract``).
    """

    name = "paged"

    def __init__(self, paged_attn: str = "gather", kv_dtype: str = "bf16"):
        if paged_attn not in ("gather", "kernel"):
            raise ValueError(
                f"paged_attn must be 'gather' or 'kernel' "
                f"(got {paged_attn!r})")
        self.attn_impl = paged_attn
        self.kv_dtype = kvquant.validate_kv_dtype(kv_dtype)
        self.prefill_impl = None

    def build_manager(self, model, batch_size, max_seq, config):
        mgr = PagedCacheManager(
            model, batch_size, max_seq,
            block_size=config.kv_block_size,
            pool_blocks=config.kv_pool_blocks,
            kv_dtype=self.kv_dtype)
        self.state_impl = "rows" if mgr.state is not None else "none"
        return mgr

    def wire_scheduler(self, scheduler, manager) -> None:
        # Admission is gated on free blocks (a request that fits max_seq
        # but not the pool queues), admit allocates the reservation,
        # retire returns it; the submit gate rejects a reservation larger
        # than the TOTAL pool at the submission boundary.
        scheduler.admission_gate = manager.can_admit
        scheduler.submit_gate = manager.infeasible_reason
        scheduler.on_admit = manager.admit_slot
        scheduler.on_retire = manager.release_slot

    def make_step(self, model, sampler_cfg, manager):
        sample = make_sampler(sampler_cfg)
        if self.attn_impl == "kernel":
            return make_paged_kernel_fused(model, sample, manager)
        return make_paged_fused(model, sample, manager)

    def make_prefill_step(self, model, sampler_cfg, manager):
        """The paged prefill chunk of slot ``islot``: ``kernel`` runs the
        model's ``paged_prefill_step`` on the slot's table row (chunk K/V
        scattered straight into its blocks, kernel B2 over the prefix);
        ``gather`` gathers the slot's dense view — its blocks through its
        table row, its state through its state row — runs the same dense
        ``prefill_step`` the contiguous rungs run and scatters the state
        row and every block of the view back.  A family without a paged
        prefill step (the recurrent ones) takes the gather chunk under
        either ``paged_attn``; ``prefill_impl`` records the one built."""
        if model.prefill_step is None:
            return None
        sample = make_sampler(sampler_cfg)
        plan, splan, kv_dtype = manager.plan, manager.state_plan, \
            manager.kv_dtype

        if self.attn_impl == "kernel" and model.paged_prefill_step is not None:
            self.prefill_impl = "kernel"

            def _prefill(params, cache, tables, islot, tokens, start, last,
                         seeds):
                pool, scales = split_cache(cache, plan.quantized)
                logits = model.paged_prefill_step(
                    params, pool, tables[islot:islot + 1], tokens, start,
                    last, scales=scales, kv_dtype=kv_dtype)[0]
                return sample(logits, seeds)[0], cache
            return _prefill

        self.prefill_impl = "gather"
        dense_prefill = shared_steps(model, sampler_cfg)["prefill"]

        def _prefill(params, cache, *rest):
            extras, (islot, tokens, start, last, seeds) = rest[:-5], rest[-5:]
            tables, rows = _split_extras(manager, extras)
            row_t = None if tables is None else tables[islot:islot + 1]
            row_r = None if rows is None else rows[islot:islot + 1]
            pool, scales = split_cache(cache, plan.quantized)
            token, dense = dense_prefill(
                params, _gather_view(manager, pool, scales, row_t, row_r), 0,
                tokens, start, last, seeds)
            if row_r is not None:
                splan.scatter(pool, row_r, dense)
            if row_t is not None:
                plan.scatter_view(pool, row_t, dense, scales,
                                  lengths=start + tokens.shape[1])
            return token, cache
        return _prefill

    def make_solo_prefill(self, model, sampler_cfg, max_seq, config):
        """A private batch-1 pool (same block size and stored dtype, one
        full reservation, and on a mixed pool one state row) driven by
        this layout's prefill step — on the kernel variant B2 — read back
        as the dense view of its table and its row."""
        mgr = self.build_manager(model, 1, max_seq,
                                 dataclasses.replace(config,
                                                     kv_pool_blocks=0))
        mgr.grow_slot(0, max_seq)
        if mgr.state is not None:
            mgr.state.admit_slot(0)
        extras = mgr.step_extras()
        tables, rows = _split_extras(mgr, extras)
        step = self.make_prefill_step(model, sampler_cfg, mgr)

        def dense(cache):
            pool, scales = split_cache(cache, mgr.plan.quantized)
            view = _gather_view(mgr, pool, scales, tables, rows)
            return {name: leaf[:, :, :max_seq] if name in mgr.plan.leaf_specs
                    else leaf for name, leaf in view.items()}

        return (mgr.cache,
                lambda params, cache, *args: step(params, cache, *extras, 0,
                                                  *args),
                dense)

    def make_verify_step(self, model, sampler_cfg, manager):
        """The paged speculative verify: ``kernel`` runs the model's
        ``paged_verify_step`` (window K/V scattered into pool blocks,
        kernel B2 over each prefix); ``gather`` materializes every slot's
        dense view, runs the same dense ``verify_step`` the contiguous
        rung runs and scatters the WHOLE view back.  Writes past a slot's
        reservation land in NULL table entries, so rejection rolls back
        by slot-length truncation alone and blocks never leak."""
        if model.verify_step is None:
            return None
        sample = make_sampler(sampler_cfg)
        plan, kv_dtype = manager.plan, manager.kv_dtype

        if self.attn_impl == "kernel":
            def _verify(params, cache, tables, tokens, start):
                pool, scales = split_cache(cache, plan.quantized)
                logits = model.paged_verify_step(
                    params, pool, tables, tokens, start, scales=scales,
                    kv_dtype=kv_dtype)[0]
                return sample(logits, None), cache
            return _verify

        dense_verify = shared_steps(model, sampler_cfg)["verify"]

        def _verify(params, cache, tables, tokens, start):
            pool, scales = split_cache(cache, plan.quantized)
            greedy, dense = dense_verify(
                params, plan.gather(pool, tables, scales), tokens, start)
            plan.scatter_view(pool, tables, dense, scales,
                              lengths=start + tokens.shape[1])
            return greedy, cache
        return _verify


def select_layout(config) -> KVLayout:
    """The layout axis of the config, as a strategy object."""
    if config.kv_layout == "paged":
        return PagedLayout(config.paged_attn, kv_dtype=config.kv_dtype)
    return ContiguousLayout()
