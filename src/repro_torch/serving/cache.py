"""Per-slot decode-cache management at the contiguous rungs (port of
``repro/serving/cache.py``).

The cache holds one ``batch x max_seq`` slice per slot (batch axis
located via the model's ``cache_axes``); admitting a request into slot
``i`` resets that slot's slice, and how is the paper's memory ladder:

  O0 (no data caching)   — per-request cache REBUILD: a fresh cache is
      allocated and every surviving slot's slice copied across, one copy
      per (leaf x live slot); nothing persistent is reused in place.
  O1..O4 (data caching)  — the cache is a persistent device-resident
      scratchpad; admission zeroes each admitted slot's slice in place,
      one write per slot per leaf.
  O5 (scratchpad reorg)  — packed slot resets: every slot admitted in one
      tick is zeroed by a single ``index_fill_`` per leaf.
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
        self.model = model
        self.B = batch_size
        self.max_seq = max_seq
        self.level = level
        self.cache = model.init_cache(batch_size, max_seq)
        self.batch_axes = batch_axes(model)

    @property
    def capacity_tokens(self) -> int:
        """Persistent decode-cache capacity in token positions: the
        contiguous cache reserves the full horizon for every slot (the
        reservation the paged manager's block pool replaces)."""
        return self.B * self.max_seq

    def step_extras(self, parked=None) -> tuple:
        """Per-tick step inputs beyond (params, cache, tokens, positions,
        seeds): none for the contiguous layout (the paged manager returns
        its block tables and state rows) — keeps the engine's dispatch
        layout-blind.  ``parked`` is the paged manager's; the contiguous
        layout never chunks a carried-state family, so it parks
        nothing."""
        del parked
        return ()

    def insert_slot(self, i: int, state) -> None:
        """Install an externally prefilled batch-1 cache (the INSERT phase
        of prefill -> insert -> generate): each leaf of ``state`` matches
        the engine's leaf with its batch axis 1 long and is copied over
        slot ``i``'s slice."""
        if state.keys() != self.cache.keys():
            raise ValueError(f"prefill state leaves {sorted(state)} != "
                             f"cache leaves {sorted(self.cache)}")
        for name, leaf in self.cache.items():
            bax = self.batch_axes[name]
            leaf.select(bax, i).copy_(state[name].select(bax, 0))

    def reset_slots(self, indices: list, live: list):
        """Reset the cache slices of ``indices`` (newly admitted slots).
        ``live`` are the slots whose state must survive — only the O0
        rebuild needs them."""
        if not indices:
            return
        if not self.level.has(Step.DATA_CACHING):
            self._rebuild(set(indices), live)
        elif self.level.has(Step.SCRATCHPAD_REORG):
            idx = torch.as_tensor(indices, dtype=torch.long,
                                  device=self.model.device)
            for name, leaf in self.cache.items():
                leaf.index_fill_(self.batch_axes[name], idx, 0)
        else:
            for i in indices:
                for name, leaf in self.cache.items():
                    leaf.select(self.batch_axes[name], i).zero_()

    def _rebuild(self, dropped: set, live: list):
        """O0: no in-place scratchpad — a fresh cache with every surviving
        slot's slice copied over, slot by slot, leaf by leaf."""
        fresh = self.model.init_cache(self.B, self.max_seq)
        keep = [i for i in live if i not in dropped]
        for name, new in fresh.items():
            bax, old = self.batch_axes[name], self.cache[name]
            for i in keep:
                new.select(bax, i).copy_(old.select(bax, i))
        self.cache = fresh
