"""Per-slot decode-cache management for the contiguous rungs (port of
``repro/serving/cache.py``).

The cache is a persistent device-resident scratchpad (``batch x
max_seq`` per slot, batch axis located via the model's ``cache_axes``);
admitting a request into slot ``i`` resets that slot's slice in place:

  O1..O4 (data caching)  — zero each admitted slot's slice, one write per
      slot per leaf.
  O5 (scratchpad reorg)  — packed slot resets: every slot admitted in one
      tick is zeroed by a single ``index_fill_`` per leaf.

The O0 per-request cache rebuild is not ported (ROADMAP A5).
"""

from __future__ import annotations

import torch

from repro_torch.core.optlevel import OptLevel, Step


def batch_axes(model) -> dict:
    """Batch axis of every cache leaf, by leaf name."""
    return {name: ax.index("batch")
            for name, ax in model.cache_axes().items()}


class CacheManager:
    def __init__(self, model, batch_size: int, max_seq: int,
                 level: OptLevel = OptLevel.O5):
        if not level.has(Step.DATA_CACHING):
            raise NotImplementedError(
                "O0's per-request cache rebuild is not ported yet "
                "(ROADMAP A5)")
        self.model = model
        self.B = batch_size
        self.max_seq = max_seq
        self.level = level
        self.cache = model.init_cache(batch_size, max_seq)
        self.batch_axes = batch_axes(model)

    def step_extras(self) -> tuple:
        """Per-tick step inputs beyond (params, cache, tokens, positions,
        seeds): none for the contiguous layout (the paged manager returns
        its block tables) — keeps the engine's dispatch layout-blind."""
        return ()

    def reset_slots(self, indices: list, live: list):
        """Zero the cache slices of ``indices`` (newly admitted slots) in
        place.  ``live`` is the rebuild path's argument (not ported)."""
        del live
        if not indices:
            return
        if self.level.has(Step.SCRATCHPAD_REORG):
            idx = torch.as_tensor(indices, dtype=torch.long,
                                  device=self.model.device)
            for name, leaf in self.cache.items():
                leaf.index_fill_(self.batch_axes[name], idx, 0)
            return
        for i in indices:
            for name, leaf in self.cache.items():
                leaf.select(self.batch_axes[name], i).zero_()
