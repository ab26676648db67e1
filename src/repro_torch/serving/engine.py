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
                         ``paged_attn`` picks the gather steps or the CUDA
                         paged-attention kernels (B1 decode, B2 windows).
  O7 speculative decode — a small drafter model proposes ``draft_k``
                         tokens per generating slot per tick; the target
                         verifies the whole batch's windows in ONE
                         multi-token forward (the layout's verify step)
                         and greedy rejection accepts exactly the
                         target's argmax prefix, so output equals plain
                         greedy decoding while up to ``1 + draft_k``
                         tokens land per slot per tick.  Rollback is
                         free: rejected writes sit beyond the slot's
                         frontier (rewritten before an unmasked read) or
                         in the NULL block.  No drafter, ``draft_k == 0``
                         or a stochastic sampler leave the engine
                         decoding plainly, recorded in ``spec_mode``
                         ("draft" / "off").  The speculative tick
                         replaces the O4 double-buffered schedule
                         (acceptance must be known before the next window
                         is drafted).

Prefill has two implementations:

  * prestaged (``config.prefill_chunk == 0``): every tick feeds one token
    per active slot — a slot still consuming its prompt feeds its next
    prompt token (logits discarded), a generating slot its last sampled
    token; TTFT is prompt-length ticks.
  * chunked (``config.prefill_chunk > 0``): one batch-1 chunk of up to
    ``prefill_chunk`` prompt tokens per tick for the head of the
    scheduler's prefill queue, interleaved with the batched decode step
    over the generating slots (prefilling slots are parked in that step:
    fed their real next prompt token, whose write a later chunk
    rewrites, but advanced only by chunks).  TTFT drops to
    ``ceil(prompt_len / chunk)`` ticks.  ``prefill_mode`` records which
    one runs ("chunked" / "token"); greedy tokens are the same.

Not ported yet, raising ``NotImplementedError`` naming its ROADMAP item:
the un-pipelined O0/O1 per-request loop and the prefill / insert /
generate API (A5).

Admission, slot bookkeeping and retirement live in ``scheduler``; the
engine is only the tick loop that wires scheduler, cache manager, sampler
and overlap together under one config.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.optlevel import BestEffortConfig, OptLevel, Step
from repro_torch.models import model_zoo
from repro_torch.serving.layout import select_layout, shared_steps
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
                 policy: str = "fcfs", draft_model=None, draft_params=None):
        self.config = config or BestEffortConfig(level=OptLevel.O5)
        self.level = self.config.level
        if not self.level.has(Step.PIPELINING):
            raise NotImplementedError(
                f"O{int(self.level)}: the un-pipelined per-request loop "
                f"(O0/O1) is not ported yet (ROADMAP A5)")
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

        # Chunked prefill: a single-slot multi-token chunk step, or None
        # (the model cannot chunk) — the tick loop then feeds prompts one
        # token per tick.
        self._prefill_chunk = int(self.config.prefill_chunk)
        self._prefill_fn = None
        if self._prefill_chunk > 0:
            self._prefill_fn = self.layout.make_prefill_step(
                model, self.sampler_cfg, self.cache_mgr)
        self.prefill_mode = ("chunked" if self._prefill_fn is not None
                             else "token")

        # O7: speculative decoding, active only when every piece is in
        # place — the rung, a drafter (by name in the config or passed
        # in), draft_k > 0, a greedy sampler and a layout verify step.
        # Anything missing leaves the plain decode path, recorded in
        # ``spec_mode``.  A vocab-incompatible (drafter, target) pair
        # raises (``model_zoo.compatible_drafter``): an operator error.
        self._spec = False
        self.spec_mode = "off"
        self._draft_k = max(int(self.config.draft_k), 0)
        self._verify_fn = None
        self.spec_drafted = self.spec_accepted = 0
        self.spec_emitted = self.spec_ticks = self.spec_windows = 0
        # Counter values at the last spec_stats_window reset.
        self._spec_window_base = (0, 0, 0, 0, 0)
        self._dstate = [(-1, 0)] * batch_size   # per-slot (rid, drafter pos)
        spec_wanted = (self.level.has(Step.SPECULATIVE)
                       and (draft_model is not None
                            or bool(self.config.draft_model))
                       and self._draft_k > 0)
        if spec_wanted and not self.sampler_cfg.stochastic:
            self._verify_fn = self.layout.make_verify_step(
                model, self.sampler_cfg, self.cache_mgr)
            if self._verify_fn is not None:
                self._wire_drafter(draft_model, draft_params)
                self._spec = True
                self.spec_mode = "draft"

    def _wire_drafter(self, api, params):
        """Build (or adopt) the drafter: a small zoo model with its own
        batch-B contiguous cache, running the shared greedy decode step.
        ``model_zoo.compatible_drafter`` validates the pairing — the
        drafter proposes token IDS the target scores, so the two must
        share one vocab.  Default drafter weights are random, drawn on
        the device from seed 0."""
        if api is None:
            dcfg = model_zoo.compatible_drafter(self.model.cfg,
                                                self.config.draft_model)
            api = model_zoo.get_model(dcfg, device=self.device)
        else:
            model_zoo.compatible_drafter(self.model.cfg, api.cfg)
        if api.device != self.device:
            raise ValueError(f"drafter on {api.device}, target on "
                             f"{self.device}")
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0)
            params = api.init(gen)
        self._draft_params = params
        self._draft_cache = api.init_cache(self.B, self.max_seq)
        dsteps = shared_steps(api, SamplerConfig())     # greedy drafts
        self._draft_fused = dsteps["fused"]
        self._draft_prefill_fn = (dsteps["prefill"]
                                  if api.prefill_step is not None else None)
        self._draft_seeds = [0] * self.B

    # -- public API -----------------------------------------------------------
    @property
    def cache(self):
        return self.cache_mgr.cache

    def _spec_dict(self, drafted, accepted, emitted, windows) -> dict:
        return {
            "spec_mode": self.spec_mode,
            "draft_k": self._draft_k if self._spec else 0,
            "drafted": drafted,
            "accepted": accepted,
            "accept_rate": (accepted / drafted) if drafted else 0.0,
            "emitted": emitted,
            "eff_tok_per_step": (emitted / windows) if windows else 0.0,
        }

    @property
    def spec_stats(self) -> dict:
        """Speculation counters over the engine's lifetime: drafts
        proposed / accepted, tokens emitted through verify windows,
        ``accept_rate`` (accepted / proposed) and ``eff_tok_per_step``
        (tokens emitted per slot per verify window, in [1, K+1])."""
        return self._spec_dict(self.spec_drafted, self.spec_accepted,
                               self.spec_emitted, self.spec_windows)

    def spec_stats_window(self, *, reset: bool = True) -> dict:
        """The same counters over the window since the last reset (a
        long-running server's per-interval view); ``reset=True`` starts
        the next window at the current counters.  The lifetime counters
        are never rewound."""
        cur = (self.spec_drafted, self.spec_accepted, self.spec_emitted,
               self.spec_ticks, self.spec_windows)
        drafted, accepted, emitted, _ticks, windows = (
            c - b for c, b in zip(cur, self._spec_window_base))
        if reset:
            self._spec_window_base = cur
        return self._spec_dict(drafted, accepted, emitted, windows)

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
        if self._spec:
            return self._step_spec()
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

    def _prefill_tick(self, i: int):
        """Dispatch one prefill CHUNK for slot ``i`` and do its
        bookkeeping: up to ``prefill_chunk`` prompt tokens in one batch-1
        multi-token step, padded to the fixed chunk width.  The chunk
        that consumes the LAST prompt token also emits the request's
        first generated token, sampled on the device from the chunk's
        closing logits and handed to ``advance`` so all retirement logic
        is reused; earlier chunks only move the position
        (``advance_chunk``)."""
        sched = self.scheduler
        s = sched.slots[i]
        r = s.req
        C = self._prefill_chunk
        start = s.pos
        n = min(C, r.n_prompt - start)
        toks = np.full((1, C), self.pad_id, np.int32)
        toks[0, :n] = r.prompt[start:start + n]
        final = start + n == r.n_prompt
        cfg = self.sampler_cfg
        seed = cfg.request_seed(r.rid, 0) if cfg.stochastic and final else 0
        tok_dev, self.cache_mgr.cache = self._prefill_fn(
            self.params, self.cache_mgr.cache,
            *self.cache_mgr.step_extras(), i, self._host_to_device(toks),
            self._host_to_device([start]), self._host_to_device([n - 1]),
            [seed])
        if final:
            sched.advance_chunk(i, n - 1)
            sched.advance(i, int(tok_dev))
        else:
            sched.advance_chunk(i, n)

    # -- speculative decoding (O7) -------------------------------------------
    def _token_at(self, i: int, q: int) -> int:
        """Token ``q`` of slot ``i``'s sequence (prompt, then generated) —
        what the drafter replays while catching up to the target."""
        r = self.scheduler.slots[i].req
        return r.prompt[q] if q < r.n_prompt else r.generated[q - r.n_prompt]

    def _draft_dispatch(self, tokens_np, positions_np):
        """One batched drafter decode tick on the drafter's own cache;
        returns the (B,) drafted tokens on the host."""
        toks, self._draft_cache = self._draft_fused(
            self._draft_params, self._draft_cache,
            self._host_to_device(tokens_np),
            self._host_to_device(positions_np), self._draft_seeds)
        return toks.cpu().numpy().reshape(self.B, -1)[:, -1]

    def _draft_catchup_chunks(self, i: int, tgt: int):
        """Replay a LONG stretch of slot ``i``'s known tokens (a fresh
        tenant's whole prompt) into the drafter cache through the
        drafter's chunked prefill step, in fixed-width chunks."""
        C = 16
        rid, dpos = self._dstate[i]
        while dpos < tgt:
            n = min(C, tgt - dpos)
            toks = np.full((1, C), self.pad_id, np.int32)
            toks[0, :n] = [self._token_at(i, q) for q in range(dpos,
                                                               dpos + n)]
            _, self._draft_cache = self._draft_prefill_fn(
                self._draft_params, self._draft_cache, i,
                self._host_to_device(toks), self._host_to_device([dpos]),
                self._host_to_device([n - 1]), [0])
            dpos += n
        self._dstate[i] = (rid, dpos)

    def _draft_tokens(self, emit: list) -> dict:
        """Catch the drafter up to each emitting slot's frontier, then
        run K batched greedy drafter ticks from the pending token;
        returns ``{slot: [d_1 .. d_K]}``.

        Catch-up replays KNOWN tokens only (prompt + accepted output),
        so the drafter cache never depends on rejected drafts: after a
        partial acceptance the drafter position is truncated to the
        accepted frontier and the stale draft K/V beyond it is rewritten
        here before the drafter attends it unmasked.  Slots not drafted
        in a dispatch are parked: pad token written at ``max_seq - 1``,
        a position every real consumer rewrites before reading it."""
        slots = self.scheduler.slots
        K = self._draft_k
        for i in emit:
            rid = slots[i].req.rid
            if self._dstate[i][0] != rid:
                self._dstate[i] = (rid, 0)      # fresh tenant: replay all
            if (self._draft_prefill_fn is not None
                    and slots[i].pos - self._dstate[i][1] > 2 * (K + 1)):
                self._draft_catchup_chunks(i, slots[i].pos)
        while True:
            behind = [i for i in emit if self._dstate[i][1] < slots[i].pos]
            if not behind:
                break
            tokens = np.full((self.B, 1), self.pad_id, np.int32)
            positions = np.full((self.B,), self.max_seq - 1, np.int32)
            for i in behind:
                dpos = self._dstate[i][1]
                tokens[i, 0] = self._token_at(i, dpos)
                positions[i] = dpos
            self._draft_dispatch(tokens, positions)
            for i in behind:
                rid, dpos = self._dstate[i]
                self._dstate[i] = (rid, dpos + 1)
        drafts = {i: [] for i in emit}
        cur = {i: slots[i].next_token() for i in emit}
        for j in range(K):
            tokens = np.full((self.B, 1), self.pad_id, np.int32)
            positions = np.full((self.B,), self.max_seq - 1, np.int32)
            for i in emit:
                tokens[i, 0] = cur[i]
                positions[i] = slots[i].pos + j
            out = self._draft_dispatch(tokens, positions)
            for i in emit:
                cur[i] = int(out[i])
                drafts[i].append(cur[i])
        for i in emit:
            # Drafter K/V now covers positions .. pos+K-1; acceptance
            # bookkeeping truncates this back if drafts are rejected.
            self._dstate[i] = (self._dstate[i][0], slots[i].pos + K)
        return drafts

    def _step_spec(self) -> bool:
        """One speculative tick: draft K per generating slot, verify the
        whole batch's windows in ONE multi-token target forward, accept
        each slot's longest draft == argmax prefix plus the target's
        bonus/correction token, and roll rejected tails back by frontier
        truncation.  Prompt-consuming slots ride the SAME verify forward
        as fixed-width prefill chunks; slots within K of the ``max_seq``
        boundary (where window positions would clip onto each other)
        take a plain decode dispatch instead — at most their last few
        ticks."""
        sched = self.scheduler
        slots = sched.slots
        admitted = sched.admit()
        active = sched.active_indices
        self.cache_mgr.reset_slots(admitted, active)
        if not active:
            return False
        K = self._draft_k
        W = K + 1
        emit, boundary, prefill = [], [], []
        for i in active:
            s = slots[i]
            if s.pos < s.req.n_prompt - 1:
                prefill.append(i)
            elif s.pos + K < self.max_seq:
                emit.append(i)
            else:
                boundary.append(i)

        drafts = self._draft_tokens(emit) if emit else {}

        greedy = None
        if emit or prefill:
            tokens = np.full((self.B, W), self.pad_id, np.int32)
            start = np.full((self.B,), self.max_seq - 1, np.int32)
            pf_real = {}
            for i in emit:
                s = slots[i]
                start[i] = s.pos
                tokens[i, 0] = s.next_token()
                tokens[i, 1:] = drafts[i]
            for i in prefill:
                s = slots[i]
                r = s.req
                start[i] = s.pos
                n = min(W, r.n_prompt - s.pos)
                tokens[i, :n] = r.prompt[s.pos:s.pos + n]
                pf_real[i] = n
            toks_dev, self.cache_mgr.cache = self._verify_fn(
                self.params, self.cache_mgr.cache,
                *self.cache_mgr.step_extras(),
                self._host_to_device(tokens), self._host_to_device(start))
            self.n_steps += 1
            greedy = toks_dev.cpu().numpy().reshape(self.B, W)

        btoks = None
        if boundary:
            tokens_np = np.full((self.B, 1), self.pad_id, np.int32)
            positions_np = np.full((self.B,), self.max_seq - 1, np.int32)
            for i in boundary:
                s = slots[i]
                tokens_np[i, 0] = s.next_token()
                positions_np[i] = s.pos
            btoks = self._dispatch(tokens_np, positions_np,
                                   [0] * self.B).cpu().numpy()

        # -- bookkeeping (host) ----------------------------------------------
        if emit:
            self.spec_ticks += 1
        for i in emit:
            g = greedy[i]
            d = drafts[i]
            a = 0
            while a < K and d[a] == g[a]:
                a += 1          # draft j+1 must equal the target's row j
            p = slots[i].pos
            rid = slots[i].req.rid
            n_rec, _ = sched.advance_multi(i, [int(x) for x in g[:a + 1]])
            self.spec_drafted += K
            self.spec_accepted += a
            self.spec_emitted += n_rec
            self.spec_windows += 1
            # Truncate the drafter to what survived: positions beyond
            # pos + n_rec hold rejected-draft K/V, replayed from the
            # accepted tokens before the next draft attends them.
            self._dstate[i] = (rid, min(p + K, p + n_rec))
        for i in prefill:
            s = slots[i]
            n = pf_real[i]
            if s.pos + n == s.req.n_prompt:     # window closes the prompt
                sched.advance_chunk(i, n - 1)
                sched.advance(i, int(greedy[i][n - 1]))
            else:
                sched.advance_chunk(i, n)
        for i in boundary:
            sched.advance(i, int(btoks[i]))
        return True

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
        # Chunked prefill: one prompt chunk (head of the prefill queue)
        # dispatches before the batched step; slots still consuming
        # their prompt are PARKED in that step — fed their real next
        # prompt token (a later chunk rewrites that write) but advanced
        # only by chunks.
        if self._prefill_fn is not None:
            pf = sched.prefill_queue()
            if pf:
                self._prefill_tick(pf[0])
                active = sched.active_indices   # the chunk may retire
            gen = [i for i in active
                   if slots[i].pos >= slots[i].req.n_prompt]
            if not gen:
                return True                     # a prefill-only tick
        else:
            gen = active

        tokens_np = [[s.next_token() if s.active else self.pad_id]
                     for s in slots]
        positions_np = [s.pos if s.active else 0 for s in slots]
        seeds_np = ([cfg.request_seed(s.req.rid, len(s.req.generated))
                     if s.active else 0 for s in slots]
                    if cfg.stochastic else [0] * self.B)
        toks = self._dispatch(tokens_np, positions_np, seeds_np).cpu()
        for i in gen:
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
        # Chunked prefill rides the overlap seam: the chunk dispatches
        # behind the decode step (prefilling slots were parked in it),
        # and tick_advance skips the prefilling slots, whose positions
        # move through the chunk's own bookkeeping.
        gen = active
        if self._prefill_fn is not None:
            gen = [i for i in active
                   if sched.slots[i].pos >= sched.slots[i].req.n_prompt]
            pf = sched.prefill_queue()
            if pf:
                self._prefill_tick(pf[0])
        emissions = sched.tick_advance(gen)
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
