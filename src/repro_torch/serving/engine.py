"""Slot-based continuous-batching decode engine, built at an OptLevel
(port of ``repro/serving/engine.py``).

The rungs, each a real, independently toggleable stage keyed by
``BestEffortConfig.level``:

  O1 data caching      — persistent device-resident cache with in-place
                         per-slot resets (``cache.CacheManager``); O0
                         rebuilds the cache at every admission.
  O2 pipelining        — continuous batching: every active slot decodes in
                         ONE fused step with sampling on the device, so
                         only the (B,) sampled ids come back per tick;
                         O0/O1 run the un-pipelined loop — one batch-1
                         model call per request per tick, sampling off the
                         device step (greedy: numpy ``argmax`` over the
                         request's logits copied to the host; stochastic:
                         the sampler as a device call of its own).
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
                         in the NULL block.  No drafter, ``draft_k == 0``,
                         a stochastic sampler or a family with no verify
                         step (rwkv6, mamba2: a carried state cannot roll
                         back) leave the engine decoding plainly,
                         recorded in ``spec_mode`` ("draft" / "off"; the
                         last two say why in ``spec_off_reason``).  The speculative tick
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
    one runs ("chunked" / "token"); greedy tokens are the same.  The
    un-pipelined O0/O1 loop always feeds prompts a token per tick.

The phases are also exposed directly (the JetStream-style serving API):
``prefill(prompt)`` consumes a prompt on a standalone batch-1 cache of
the engine's layout (a private pool on the paged layout) through the
prefill step admission runs and samples the first token — token by
token through the batch-1 decode step for a carried-state family —
``insert(result)`` installs that state into a free slot (scattering it
through a freshly reserved block table, or copying it into the slot's
state row, under the paged layout), and ``generate()`` drains the
decode loop.

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
from repro_torch.serving.paged import is_state_leaf
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


@dataclasses.dataclass
class PrefillResult:
    """Output of the standalone PREFILL phase — everything INSERT needs:
    the request (rid already assigned, so stochastic seeds are stable),
    the first sampled token, and the batch-1 dense cache holding the
    prompt's K/V (zero past the prompt)."""
    request: Request
    first_token: int
    kv_state: object
    length: int          # prompt tokens consumed


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
        self._fused = self.level.has(Step.PIPELINING)
        if self._fused:
            self._step_fn = self.layout.make_step(model, self.sampler_cfg,
                                                  self.cache_mgr)
        else:
            # O0/O1: the un-pipelined loop — each active request runs its
            # OWN batch-1 model call per tick (every request pays a pass
            # over the weights), and sampling runs off the device step.
            shared = shared_steps(model, self.sampler_cfg)
            self._single_fn = shared["single"]
            self._sample_fn = shared["sample"]

        # O4: host/device overlap via rotating prestaged buffers plus the
        # split-tick protocol (dispatch -> bookkeeping under the running
        # step -> finalize next tick).
        self._overlap = (HostOverlap(batch_size, pad_id,
                                     self.config.effective_buffers)
                         if self.level.has(Step.DOUBLE_BUFFERING) else None)
        self._pending = None        # (toks_device, emissions) of last tick

        # Chunked prefill: a single-slot multi-token chunk step, or None
        # (the model cannot chunk, or the un-pipelined loop) — the tick
        # loop then feeds prompts one token per tick.
        self._prefill_chunk = int(self.config.prefill_chunk)
        self._prefill_fn = None
        if self._prefill_chunk > 0 and self._fused:
            self._prefill_fn = self.layout.make_prefill_step(
                model, self.sampler_cfg, self.cache_mgr)
        self.prefill_mode = ("chunked" if self._prefill_fn is not None
                             else "token")
        # A requested capability that fell back says why (chunked prefill
        # of a carried-state family on the contiguous layout).
        self.degrade_reason = self.layout.degrade_reason

        # O7: speculative decoding, active only when every piece is in
        # place — the rung, a drafter (by name in the config or passed
        # in), draft_k > 0, a greedy sampler and a layout verify step.
        # Anything missing leaves the plain decode path, recorded in
        # ``spec_mode``.  A vocab-incompatible (drafter, target) pair
        # raises (``model_zoo.compatible_drafter``): an operator error.
        self._spec = False
        self.spec_mode = "off"
        self.spec_off_reason = None       # why a wanted O7 decodes plainly
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
        if spec_wanted and self.sampler_cfg.stochastic:
            self.spec_off_reason = "a stochastic sampler"
        elif spec_wanted:
            self._verify_fn = self.layout.make_verify_step(
                model, self.sampler_cfg, self.cache_mgr)
            if self._verify_fn is not None:
                self._wire_drafter(draft_model, draft_params)
                self._spec = True
                self.spec_mode = "draft"
            else:
                self.spec_off_reason = (
                    f"family {model.cfg.family!r} has no verify step")

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

    # -- prefill -> insert -> generate ---------------------------------------
    def prefill(self, prompt, *, max_new_tokens: int = 16,
                eos_id: Optional[int] = None) -> PrefillResult:
        """PREFILL phase: consume ``prompt`` on a standalone batch-1 cache
        of the engine's own layout, in chunks of the engine's
        ``prefill_chunk`` (else ``min(len(prompt), 64)``) through the
        layout's prefill step (on the paged kernel layout a private pool
        and B2), and sample the first generated token.  No engine slot is
        touched: :meth:`insert` installs the returned state and
        :meth:`generate` decodes from there, with the tokens of
        submitting the same request.  The state is a batch-1 dense cache
        zeroed past the prompt (a padded final chunk writes its pad rows
        there), so a narrow pool's insert quantizes the prompt alone.

        A family that carries recurrent state prefills token by token,
        as the reference's per-token path does: the batch-1 decode step
        (the O0/O1 loop's) on a batch-1 contiguous cache, the first token
        sampled from the last prompt token's logits."""
        if self.model.carries_state:
            return self._prefill_per_token(prompt, max_new_tokens, eos_id)
        if self.model.prefill_step is None:
            raise NotImplementedError(
                f"prefill of the {self.model.cfg.family!r} family is not "
                f"ported (ROADMAP A11)")
        req = self._prefill_request(prompt, max_new_tokens, eos_id)
        cfg = self.sampler_cfg
        P = req.n_prompt
        seed = cfg.request_seed(req.rid, 0) if cfg.stochastic else 0
        cache, step, dense = self.layout.make_solo_prefill(
            self.model, cfg, self.max_seq, self.config)
        C = self._prefill_chunk or min(P, 64)
        for pos in range(0, P, C):
            n = min(C, P - pos)
            toks = np.full((1, C), self.pad_id, np.int32)
            toks[0, :n] = req.prompt[pos:pos + n]
            tok_dev, cache = step(
                self.params, cache, self._host_to_device(toks),
                self._host_to_device([pos]),
                self._host_to_device([n - 1]), [seed])
        state = dense(cache)
        for name, ax in self.model.cache_axes().items():
            if not is_state_leaf(ax):           # a cross leaf is read-only
                state[name].narrow(ax.index("kv_seq"), P,
                                   self.max_seq - P).zero_()
        return PrefillResult(request=req, first_token=int(tok_dev),
                             kv_state=state, length=P)

    def _prefill_per_token(self, prompt, max_new_tokens, eos_id):
        """The carried-state families' PREFILL: one batch-1 decode step
        per prompt token on a fresh batch-1 contiguous cache."""
        req = self._prefill_request(prompt, max_new_tokens, eos_id)
        cfg = self.sampler_cfg
        shared = shared_steps(self.model, cfg)
        cache = self.model.init_cache(1, self.max_seq)
        for p, tok in enumerate(req.prompt):
            logits, cache = shared["single"](self.params, cache, tok, p, 0)
        if cfg.stochastic:
            first = int(shared["sample"](logits[None],
                                         [cfg.request_seed(req.rid, 0)])[0])
        else:
            first = int(logits.cpu().numpy().argmax())
        return PrefillResult(request=req, first_token=first, kv_state=cache,
                             length=req.n_prompt)

    def _prefill_request(self, prompt, max_new_tokens, eos_id) -> Request:
        """The request a PREFILL serves, with its rid, checked against
        the engine's horizon."""
        req = Request(prompt=list(prompt), max_new_tokens=max_new_tokens,
                      eos_id=eos_id)
        req.rid = self.scheduler.new_rid()
        if req.n_prompt < 1:
            raise ValueError(f"req {req.rid}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"req {req.rid}: prefill needs max_new_tokens >= 1")
        if req.n_prompt + req.max_new_tokens > self.max_seq:
            raise ValueError(
                f"req {req.rid}: prompt ({req.n_prompt}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds engine max_seq "
                f"({self.max_seq})")
        return req

    def insert(self, result: PrefillResult,
               slot: Optional[int] = None) -> int:
        """INSERT phase: occupy a free slot with a prefilled request.
        Copies the batch-1 state over the slot's cache slice (contiguous)
        or scatters it through the slot's freshly reserved block table
        (paged), places the scheduler slot after the prompt and records
        the first token — after which the request decodes like any
        other.  Raises when no slot is free or (paged) the pool cannot
        hold the request's reservation right now; callers retry after
        retirements."""
        sched = self.scheduler
        req = result.request
        if slot is None:
            free = [i for i, s in enumerate(sched.slots) if not s.active]
            if not free:
                raise ValueError("no free slot to insert into")
            slot = free[0]
        if sched.submit_gate is not None:
            reason = sched.submit_gate(req)
            if reason:
                # Never fits: no retirement will ever make room.
                raise ValueError(f"req {req.rid}: {reason}")
        if (sched.admission_gate is not None
                and not sched.admission_gate(req)):
            raise ValueError(
                "insufficient free KV blocks to insert (retire requests "
                "or enlarge the pool)")
        sched.place(req, slot)          # fires on_admit (block reserve)
        self.cache_mgr.insert_slot(slot, result.kv_state)
        sched.advance(slot, result.first_token)
        return slot

    def generate(self, *, max_ticks: int = 10_000) -> list:
        """GENERATE phase: drain inserted and queued requests — :meth:`run`
        under the name of the prefill -> insert -> generate protocol."""
        return self.run(max_ticks=max_ticks)

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

    def _dispatch(self, tokens_np, positions_np, seeds_np, parked=None):
        """Run the batched fused step; returns the sampled tokens (still
        on the device, possibly still computing).  The manager's
        ``step_extras()`` supplies layout-specific inputs (the paged
        manager's cached device block tables and state rows), keeping
        this path layout-blind.  ``parked`` names the slots mid-chunked-
        prefill this tick: a manager with carried state aliases them to
        the NULL state row, so the batched feed cannot advance their real
        state (their prompt advances only through ``_prefill_tick``).
        The cache is updated in place."""
        toks_dev, new_cache = self._step_fn(
            self.params, self.cache_mgr.cache,
            *self.cache_mgr.step_extras(parked=parked),
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
        """O0..O3: admit -> fill -> dispatch -> wait -> retire, in order.
        Below O2 each active request runs its own batch-1 model call, one
        after another — the per-request loop a batched tick replaces."""
        sched = self.scheduler
        admitted = sched.admit()
        active = sched.active_indices
        self.cache_mgr.reset_slots(admitted, active)
        if not active:
            return False

        cfg = self.sampler_cfg
        slots = sched.slots
        if not self._fused:
            # O0/O1: one model call per request; greedy takes numpy's
            # argmax (the first index on ties, like torch.argmax) over
            # the logits copied to the host.
            toks = {}
            for i in active:
                s = slots[i]
                logits, self.cache_mgr.cache = self._single_fn(
                    self.params, self.cache_mgr.cache, s.next_token(),
                    s.pos, i)
                if cfg.stochastic:
                    seed = cfg.request_seed(s.req.rid, len(s.req.generated))
                    toks[i] = int(self._sample_fn(logits[None], [seed])[0])
                else:
                    toks[i] = int(logits.cpu().numpy().argmax())
            self.n_steps += 1
            for i in active:
                sched.advance(i, toks[i])
            return True
        # Chunked prefill: one prompt chunk (head of the prefill queue)
        # dispatches before the batched step; slots still consuming
        # their prompt are PARKED in that step — fed their real next
        # prompt token (a later chunk rewrites that KV write; a carried
        # state is aliased to the NULL row) but advanced only by chunks.
        parked = None
        if self._prefill_fn is not None:
            pf = sched.prefill_queue()
            if pf:
                self._prefill_tick(pf[0])
                active = sched.active_indices   # the chunk may retire
            gen = [i for i in active
                   if slots[i].pos >= slots[i].req.n_prompt]
            if not gen:
                return True                     # a prefill-only tick
            parked = [i for i in active if i not in set(gen)]
        else:
            gen = active

        tokens_np = [[s.next_token() if s.active else self.pad_id]
                     for s in slots]
        positions_np = [s.pos if s.active else 0 for s in slots]
        seeds_np = ([cfg.request_seed(s.req.rid, len(s.req.generated))
                     if s.active else 0 for s in slots]
                    if cfg.stochastic else [0] * self.B)
        toks = self._dispatch(tokens_np, positions_np, seeds_np,
                              parked=parked).cpu()
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

        # Chunked prefill rides the overlap seam: prefilling slots are
        # parked in the decode step (a carried state on the NULL row),
        # the chunk dispatches behind it, and tick_advance skips them —
        # their positions move through the chunk's own bookkeeping.
        gen, parked = active, None
        if self._prefill_fn is not None:
            gen = [i for i in active
                   if sched.slots[i].pos >= sched.slots[i].req.n_prompt]
            parked = [i for i in active if i not in set(gen)]

        toks_dev = self._dispatch(buf.tokens, buf.positions,
                                  buf.seeds.tolist(), parked=parked)

        # -- bookkeeping for the next tick, under the running step -----------
        if self._prefill_fn is not None:
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
