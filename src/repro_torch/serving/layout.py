"""KVLayout: how the decode cache is stored (port of
``repro/serving/layout.py``).

The engine selects one strategy object and never branches on layout
again:

  * :class:`ContiguousLayout` — one ``batch x max_seq`` cache slice per
    slot (rungs O2..O5);
  * :class:`PagedLayout` — a pooled KV-block scratchpad with per-request
    block tables (O6).  ``paged_attn="gather"`` re-materializes each
    slot's dense view from the pool every tick, runs the SAME dense
    ``decode_step`` the contiguous rungs run and scatters back the one
    block it wrote; ``paged_attn="kernel"`` runs the model's
    ``paged_decode_step`` — the CUDA paged-decode kernel on the raw pool,
    no dense view at all.  ``attn_impl`` records what was built.

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
"""

from __future__ import annotations

from repro_torch.serving import kvquant
from repro_torch.serving.cache import CacheManager
from repro_torch.serving.paged import PagedCacheManager
from repro_torch.serving.sampler import make_sampler


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
      row."""
    sample = make_sampler(sampler_cfg)
    batch_axis = {name: ax.index("batch")
                  for name, ax in model.cache_axes().items()}

    def _prefill(params, cache, islot, tokens, start, last, seeds):
        row = {name: leaf.narrow(batch_axis[name], islot, 1)
               for name, leaf in cache.items()}       # views: in place
        logits, _ = model.prefill_step(params, row, tokens, start, last)
        return sample(logits, seeds)[0], cache

    def _verify(params, cache, tokens, start):
        logits, cache = model.verify_step(params, cache, tokens, start)
        return sample(logits, None), cache

    return {"fused": make_fused(model, sample), "prefill": _prefill,
            "verify": _verify}


def _split_cache(cache, quantized):
    """(pool, scales) from a paged step's cache: a narrow pool travels as
    a ``{"pool", "scale"}`` bundle, a wide one bare (scales None)."""
    if quantized:
        return cache["pool"], cache["scale"]
    return cache, None


def make_paged_fused(model, sample, manager):
    """The paged GATHER step: block-table gather -> the SAME dense
    ``decode_step`` the contiguous rungs run -> single-block scatter back
    into the pool (in place).  The dense view is identical to the
    contiguous cache at every unmasked position, so greedy tokens cannot
    drift from the contiguous path (a narrow pool: up to its dtype's
    tolerance contract)."""
    plan = manager.plan

    def _fused(params, cache, tables, tokens, positions, seeds):
        pool, scales = _split_cache(cache, plan.quantized)
        dense = plan.gather(pool, tables, scales)
        logits, dense = model.decode_step(params, dense, tokens, positions)
        toks = sample(logits, seeds)
        plan.scatter(pool, tables, dense, positions, scales)
        return toks, cache

    return _fused


def make_paged_kernel_fused(model, sample, manager):
    """The paged KERNEL step (``paged_attn="kernel"``): the model's
    ``paged_decode_step`` consumes the pool + tables + positions
    directly; each layer appends its token's K/V into the active block in
    place and the paged-decode kernel reads only the blocks each slot
    references."""
    quantized, kv_dtype = manager.plan.quantized, manager.kv_dtype

    def _fused(params, cache, tables, tokens, positions, seeds):
        pool, scales = _split_cache(cache, quantized)
        logits = model.paged_decode_step(params, pool, tables, tokens,
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
                         or None when the model has no prefill step (the
                         engine then feeds prompts one token per tick).
    ``make_verify_step`` — the speculative-verify step ``(params, cache,
                         *extras, tokens (B, C), start (B,)) -> (greedy
                         tokens (B, C), cache)``, or None when the model
                         has no verify step (the engine then decodes
                         plainly).
    ``attn_impl``      — the attention implementation the built steps use
                         ("gather"/"kernel"; None on the contiguous layout).
    """

    name: str = "?"
    attn_impl = None

    def build_manager(self, model, batch_size, max_seq, config):
        raise NotImplementedError

    def wire_scheduler(self, scheduler, manager) -> None:
        pass

    def make_step(self, model, sampler_cfg, manager):
        raise NotImplementedError


class ContiguousLayout(KVLayout):
    """One ``batch x max_seq`` cache slice per slot (rungs O2..O5)."""

    name = "contiguous"

    def build_manager(self, model, batch_size, max_seq, config):
        return CacheManager(model, batch_size, max_seq, config.level)

    def make_step(self, model, sampler_cfg, manager):
        return make_fused(model, make_sampler(sampler_cfg))

    def make_prefill_step(self, model, sampler_cfg, manager):
        if model.prefill_step is None:
            return None
        return shared_steps(model, sampler_cfg)["prefill"]

    def make_verify_step(self, model, sampler_cfg, manager):
        if model.verify_step is None:
            return None
        return shared_steps(model, sampler_cfg)["verify"]


class PagedLayout(KVLayout):
    """Pooled KV-block scratchpad with per-request block tables (O6).

    ``paged_attn`` selects the steps' attention implementation and is
    recorded as ``attn_impl`` (every model family of the port has paged
    decode, prefill and verify steps, so nothing degrades).  ``kv_dtype``
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

    def build_manager(self, model, batch_size, max_seq, config):
        return PagedCacheManager(
            model, batch_size, max_seq,
            block_size=config.kv_block_size,
            pool_blocks=config.kv_pool_blocks,
            kv_dtype=self.kv_dtype)

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
        ``gather`` gathers the slot's dense view, runs the same dense
        ``prefill_step`` the contiguous rungs run and scatters every
        block of the view back."""
        if model.prefill_step is None:
            return None
        sample = make_sampler(sampler_cfg)
        plan, kv_dtype = manager.plan, manager.kv_dtype

        if self.attn_impl == "kernel":
            def _prefill(params, cache, tables, islot, tokens, start, last,
                         seeds):
                pool, scales = _split_cache(cache, plan.quantized)
                logits = model.paged_prefill_step(
                    params, pool, tables[islot:islot + 1], tokens, start,
                    last, scales=scales, kv_dtype=kv_dtype)[0]
                return sample(logits, seeds)[0], cache
            return _prefill

        dense_prefill = shared_steps(model, sampler_cfg)["prefill"]

        def _prefill(params, cache, tables, islot, tokens, start, last,
                     seeds):
            pool, scales = _split_cache(cache, plan.quantized)
            row = tables[islot:islot + 1]
            token, dense = dense_prefill(
                params, plan.gather(pool, row, scales), 0, tokens, start,
                last, seeds)
            plan.scatter_view(pool, row, dense, scales,
                              lengths=start + tokens.shape[1])
            return token, cache
        return _prefill

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
                pool, scales = _split_cache(cache, plan.quantized)
                logits = model.paged_verify_step(
                    params, pool, tables, tokens, start, scales=scales,
                    kv_dtype=kv_dtype)[0]
                return sample(logits, None), cache
            return _verify

        dense_verify = shared_steps(model, sampler_cfg)["verify"]

        def _verify(params, cache, tables, tokens, start):
            pool, scales = _split_cache(cache, plan.quantized)
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
