"""Host/device overlap for the decode loop — the double-buffering step.

A verbatim copy of ``repro/serving/overlap.py`` (numpy only), kept here
so the port imports nothing of ``repro``.

The paper's 3-slot rotation (Fig. 4c/5c) overlaps load / compute / store of
adjacent iterations; ``runtime/overlap.py`` applies the same idea to the
cross-pod gradient sync.  Here it is applied to the serving hot loop: while
tick N's ``step_fn`` runs on the device, the host *prestages* tick N+1's
input buffers with everything already known — a slot still consuming its
prompt will feed ``prompt[pos + 1]`` next tick no matter what the device
returns, so its token/position entries can be written before the device
result arrives.  Only the slots whose next token IS the device's output
are filled after the sync point.

Below O4 the engine allocates fresh buffers every tick and fills them
entirely after the previous tick completes (the naive serial schedule);
at O4+ it rotates through ``n_buffers`` pre-allocated buffer sets.
"""

from __future__ import annotations

import numpy as np


class TickBuffers:
    """One set of host-side step inputs (tokens / positions / seeds)."""

    __slots__ = ("tokens", "positions", "seeds")

    def __init__(self, B: int, pad_id: int):
        self.tokens = np.full((B, 1), pad_id, np.int32)
        self.positions = np.zeros((B,), np.int32)
        self.seeds = np.zeros((B,), np.int32)


class HostOverlap:
    """Rotating pre-allocated buffer sets + the prestaged-slot ledger."""

    def __init__(self, B: int, pad_id: int, n_buffers: int = 3):
        self.pad_id = pad_id
        self._ring = [TickBuffers(B, pad_id) for _ in range(max(2, n_buffers))]
        self._k = 0
        self.prestaged: set = set()

    def rotate(self) -> TickBuffers:
        """Advance to the next buffer set (this tick's inputs).  Entries
        listed in ``self.prestaged`` were already written by last tick's
        ``prestage`` and must not be refilled."""
        self._k = (self._k + 1) % len(self._ring)
        return self._ring[self._k]

    def prestage(self, scheduler, sampler_cfg) -> TickBuffers:
        """Fill the NEXT tick's entries for slots whose input is already
        known, while the device computes this tick.

        Called after ``Scheduler.tick_advance`` (positions already point
        at the next token to consume): a slot with ``pos < n_prompt`` —
        still consuming its prompt, including slots admitted under the
        running step — will feed ``prompt[pos]`` no matter what the
        device returns.  Generating slots wait for the device's token and
        are filled after ``finalize``.  A prestaged slot cannot have
        emitted this tick (emission implies ``pos >= n_prompt``), so its
        seed input (derived from the emission count, which is position
        arithmetic) is already final too.
        """
        nxt = self._ring[(self._k + 1) % len(self._ring)]
        self.prestaged.clear()
        for i, s in enumerate(scheduler.slots):
            if not s.active:
                continue
            if s.pos < s.req.n_prompt:
                nxt.tokens[i, 0] = s.req.prompt[s.pos]
                nxt.positions[i] = s.pos
                if sampler_cfg.stochastic:
                    emitted = max(0, s.pos - s.req.n_prompt + 1)
                    nxt.seeds[i] = sampler_cfg.request_seed(
                        s.req.rid, emitted)
                self.prestaged.add(i)
        return nxt
