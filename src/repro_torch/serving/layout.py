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
pool's admission gates) and the fused decode+sample step.  The port runs
eagerly on one device, so a "step" is a plain function; placement is
the engine's single-device record.
"""

from __future__ import annotations

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


def make_paged_fused(model, sample, manager):
    """The paged GATHER step: block-table gather -> the SAME dense
    ``decode_step`` the contiguous rungs run -> single-block scatter back
    into the pool (in place).  The dense view is identical to the
    contiguous cache at every unmasked position, so greedy tokens cannot
    drift from the contiguous path."""
    plan = manager.plan

    def _fused(params, pool, tables, tokens, positions, seeds):
        dense = plan.gather(pool, tables)
        logits, dense = model.decode_step(params, dense, tokens, positions)
        toks = sample(logits, seeds)
        return toks, plan.scatter(pool, tables, dense, positions)

    return _fused


def make_paged_kernel_fused(model, sample, manager):
    """The paged KERNEL step (``paged_attn="kernel"``): the model's
    ``paged_decode_step`` consumes the pool + tables + positions
    directly; each layer appends its token's K/V into the active block in
    place and the paged-decode kernel reads only the blocks each slot
    references."""
    kv_dtype = manager.kv_dtype

    def _fused(params, pool, tables, tokens, positions, seeds):
        logits, pool = model.paged_decode_step(params, pool, tables, tokens,
                                               positions, kv_dtype=kv_dtype)
        return sample(logits, seeds), pool

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
    ``attn_impl``      — the attention implementation the built step uses
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


class PagedLayout(KVLayout):
    """Pooled KV-block scratchpad with per-request block tables (O6).

    ``paged_attn`` selects the step's attention implementation and is
    recorded as ``attn_impl`` (every model family of the port has a
    paged decode step, so nothing degrades).  ``kv_dtype`` is the pool's
    stored dtype; the manager raises for anything but "bf16".
    """

    name = "paged"

    def __init__(self, paged_attn: str = "gather", kv_dtype: str = "bf16"):
        if paged_attn not in ("gather", "kernel"):
            raise ValueError(
                f"paged_attn must be 'gather' or 'kernel' "
                f"(got {paged_attn!r})")
        self.attn_impl = paged_attn
        self.kv_dtype = kv_dtype

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


def select_layout(config) -> KVLayout:
    """The layout axis of the config, as a strategy object."""
    if config.kv_layout == "paged":
        return PagedLayout(config.paged_attn, kv_dtype=config.kv_dtype)
    return ContiguousLayout()
