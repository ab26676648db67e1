"""Slot-based continuous-batching decode engine, built at an OptLevel
(port of ``repro/serving/engine.py``).

The rungs this slice serves, each a real, independently toggleable stage
keyed by ``BestEffortConfig.level``:

  O2 pipelining        — continuous batching: every active slot decodes in
                         ONE fused step with sampling on the device, so
                         only the (B,) sampled ids come back per tick.
  O3 PE duplication    — recorded only: the port runs on one device, so
                         ``pe`` is clipped to 1 (``engine.placement``).
  O4 double buffering  — host prestages next tick's token/position
                         buffers and does slot bookkeeping while the
                         device runs this tick (``overlap``; the split
                         tick protocol of the scheduler).
  O5 scratchpad reorg  — packed slot admission: all slots admitted in a
                         tick are zeroed by one fill per cache leaf.
  O6 paged scratchpad  — the cache is a pool of fixed-size KV blocks with
                         per-request block tables (``paged``); admission
                         is gated on free blocks (queue, never reject).
                         ``paged_attn`` picks the gather step or the CUDA
                         paged-decode kernel.

Prompts take the prestaged path: every tick feeds one token per active
slot — a slot still consuming its prompt feeds its next prompt token
(logits discarded), a generating slot its last sampled token.

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: the un-pipelined O0/O1 per-request loop (A5), O7 speculative
decoding and chunked prefill (A8).

Admission, slot bookkeeping and retirement live in ``scheduler``; the
engine is only the tick loop that wires scheduler, cache manager, sampler
and overlap together under one config.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.optlevel import BestEffortConfig, OptLevel, Step
from repro_torch.serving.layout import select_layout
from repro_torch.serving.overlap import HostOverlap
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.scheduler import Request, Scheduler


class TickBudgetExceeded(RuntimeError):
    """``DecodeEngine.run`` exhausted ``max_ticks`` with work still
    queued or in flight.  Every surviving request has been marked
    ``truncated`` (its partial ``generated`` list is intact); the
    engine's slots and queue are untouched, so a caller can catch this
    and keep ticking."""

    def __init__(self, msg: str, survivors: list):
        super().__init__(msg)
        self.survivors = survivors


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where the engine's arrays live.  The port serves on one device:
    a requested PE-duplication degree above 1 is recorded here and
    clipped to 1, as the reference's ``PlacementPlan`` degrades on a
    single device."""
    requested_pe: int
    n_devices: int = 1


class DecodeEngine:
    def __init__(self, model, params, *, batch_size: int, max_seq: int,
                 pad_id: int = 0, config: Optional[BestEffortConfig] = None,
                 sampler: Optional[SamplerConfig] = None,
                 policy: str = "fcfs"):
        self.config = config or BestEffortConfig(level=OptLevel.O5)
        self.level = self.config.level
        if not self.level.has(Step.PIPELINING):
            raise NotImplementedError(
                f"O{int(self.level)}: the un-pipelined per-request loop "
                f"(O0/O1) is not ported yet (ROADMAP A5)")
        if self.level.has(Step.SPECULATIVE):
            raise NotImplementedError(
                "O7 speculative decoding is not ported yet (ROADMAP A8)")
        if self.config.prefill_chunk > 0:
            raise NotImplementedError(
                "chunked prefill (prefill_chunk > 0) is not ported yet "
                "(ROADMAP A8)")
        emb = params["embedding"]
        if emb.device != model.device:
            raise ValueError(f"params on {emb.device}, model on "
                             f"{model.device}")
        self.model = model
        self.device = model.device
        self.params = params
        self.B = batch_size
        self.max_seq = max_seq
        self.pad_id = pad_id
        self.sampler_cfg = sampler or SamplerConfig()
        self.scheduler = Scheduler(batch_size, max_seq, policy=policy)
        self.n_steps = 0

        self.layout = select_layout(self.config)
        self.placement = Placement(requested_pe=self.config.effective_pe)
        self.cache_mgr = self.layout.build_manager(
            model, batch_size, max_seq, self.config)
        self.layout.wire_scheduler(self.scheduler, self.cache_mgr)
        self._step_fn = self.layout.make_step(model, self.sampler_cfg,
                                              self.cache_mgr)

        # O4: host/device overlap via rotating prestaged buffers plus the
        # split-tick protocol (dispatch -> bookkeeping under the running
        # step -> finalize next tick).
        self._overlap = (HostOverlap(batch_size, pad_id,
                                     self.config.effective_buffers)
                         if self.level.has(Step.DOUBLE_BUFFERING) else None)
        self._pending = None        # (toks_device, emissions) of last tick

    # -- public API -----------------------------------------------------------
    @property
    def cache(self):
        return self.cache_mgr.cache

    @property
    def queue(self):
        return self.scheduler.queue

    @property
    def finished(self):
        return self.scheduler.finished

    @property
    def slots(self):
        return self.scheduler.slots

    def submit(self, req: Request) -> int:
        return self.scheduler.submit(req)

    def step(self) -> bool:
        """One engine tick: admit, run the batched decode step, retire."""
        if self._overlap is not None:
            return self._step_overlapped()
        return self._step_serial()

    def _host_to_device(self, arr):
        # Always a copy: the O4 host buffers are rewritten while the
        # device may still read this tick's inputs.
        return torch.tensor(arr, device=self.device)

    def _dispatch(self, tokens_np, positions_np, seeds_np):
        """Run the batched fused step; returns the sampled tokens (still
        on the device, possibly still computing).  The manager's
        ``step_extras()`` supplies layout-specific inputs (the paged
        manager's cached device block tables), keeping this path
        layout-blind.  The cache is updated in place."""
        toks_dev, new_cache = self._step_fn(
            self.params, self.cache_mgr.cache,
            *self.cache_mgr.step_extras(),
            self._host_to_device(tokens_np),
            self._host_to_device(positions_np), seeds_np)
        self.cache_mgr.cache = new_cache
        self.n_steps += 1
        return toks_dev

    def _step_serial(self) -> bool:
        """O2/O3: admit -> fill -> dispatch -> wait -> retire, in order."""
        sched = self.scheduler
        admitted = sched.admit()
        active = sched.active_indices
        self.cache_mgr.reset_slots(admitted, active)
        if not active:
            return False

        cfg = self.sampler_cfg
        slots = sched.slots
        tokens_np = [[s.next_token() if s.active else self.pad_id]
                     for s in slots]
        positions_np = [s.pos if s.active else 0 for s in slots]
        seeds_np = ([cfg.request_seed(s.req.rid, len(s.req.generated))
                     if s.active else 0 for s in slots]
                    if cfg.stochastic else [0] * self.B)
        toks = self._dispatch(tokens_np, positions_np, seeds_np).cpu()
        for i in active:
            sched.advance(i, int(toks[i]))
        return True

    def _step_overlapped(self) -> bool:
        """O4+: double-buffered schedule.  Each call finalizes the
        previous tick (its tokens have been computing since last call),
        dispatches this tick from mostly-prestaged buffers, then does all
        token-independent bookkeeping — position advance, count-based
        retirement planning, admission, cache-slot resets, next tick's
        prompt prestaging — while the device runs."""
        sched = self.scheduler
        cfg = self.sampler_cfg
        if self._pending is not None:
            toks_dev, emissions = self._pending
            self._pending = None
            sched.finalize(emissions, toks_dev.cpu().numpy())
        active = sched.active_indices
        if not active:
            # cold start / wake-up: nothing was admitted under a running
            # step, so admit + reset inline.
            admitted = sched.admit()
            if not admitted:
                return False
            active = sched.active_indices
            self.cache_mgr.reset_slots(admitted, active)

        # fill: only slots not prestaged during the previous tick
        buf = self._overlap.rotate()
        skip = self._overlap.prestaged
        for i in active:
            if i in skip:
                continue
            s = sched.slots[i]
            buf.tokens[i, 0] = s.next_token()
            buf.positions[i] = s.pos
            if cfg.stochastic:
                buf.seeds[i] = cfg.request_seed(
                    s.req.rid, len(s.req.generated))

        toks_dev = self._dispatch(buf.tokens, buf.positions,
                                  buf.seeds.tolist())

        # -- bookkeeping for the next tick, under the running step -----------
        emissions = sched.tick_advance(active)
        self._pending = (toks_dev, emissions)
        admitted = sched.admit()                 # refills planned-free slots
        if admitted:
            self.cache_mgr.reset_slots(admitted, sched.active_indices)
        self._overlap.prestage(sched, cfg)
        return True

    def run(self, *, max_ticks: int = 10_000) -> list:
        """Drain queue + slots; returns finished requests.  Raises
        :class:`TickBudgetExceeded` when ``max_ticks`` expires with
        requests still queued or mid-flight (each survivor marked
        ``truncated`` first)."""
        for _ in range(max_ticks):
            if not self.step() and not self.queue:
                break
        else:
            sched = self.scheduler
            if sched.has_work():
                survivors = [s.req for s in sched.slots if s.active]
                survivors += list(sched.queue)
                for r in survivors:
                    r.truncated = True
                raise TickBudgetExceeded(
                    f"run(max_ticks={max_ticks}) exhausted its tick "
                    f"budget with {len(survivors)} request(s) unfinished "
                    f"({sum(1 for s in sched.slots if s.active)} in "
                    f"flight, {len(sched.queue)} queued); survivors "
                    f"marked truncated", survivors)
        return self.finished
