"""Admission + slot bookkeeping, split out of the decode engine.

A verbatim copy of ``repro/serving/scheduler.py`` (it imports no
framework), kept here so the port imports nothing of ``repro``.

The scheduler owns the request queue, the fixed pool of B slots, and the
per-slot position arithmetic.  Three admission policies:

  * ``fcfs`` — first come, first served (the classic continuous-batching
    default; fair, latency-predictable).
  * ``spf``  — shortest-prompt-first WITH AGING: admit the queued request
    with the fewest *effective* prompt tokens, where every admission wave
    a request sits queued shaves one token off its effective length
    (``effective_prompt_len``).  Short requests still jump long prefills
    (SJF applied to the prefill phase), but a long prompt's priority
    decays to the front in at most ``n_prompt`` waves — pure SPF starves
    it FOREVER under sustained open-loop arrivals of short requests.
  * ``deadline`` — earliest-deadline-first on ``Request.deadline_s``
    (absolute ``time.monotonic`` seconds); requests without a deadline
    sort last, ties broken by arrival order.  The SLO-aware policy for
    the open-loop traffic front end (``launch/server.py``).

Request validation happens at ``submit`` time, not mid-flight: an
oversized request raises ``ValueError`` immediately instead of asserting
deep inside the engine tick, and a degenerate ``max_new_tokens <= 0``
request is retired on the spot (empty completion) rather than ever
occupying a slot — the naive path admitted it and, depending on prompt
length vs ``max_seq``, could pin the slot forever.

Submit-time validation is deliberately *static* (the single-request
``max_seq`` capacity only): under the O6 paged cache a request that fits
``max_seq`` but not the currently-free KV blocks must QUEUE until
retirements free blocks, never raise — block availability is a property
of the moment, not of the request.  That dynamic check is the
``admission_gate`` hook, consulted per candidate at admit time; a gated
candidate stays queued and ends this tick's admission wave (no
head-of-line bypass, so fcfs arrival order survives).  The cache layer
tracks slot tenancy through ``on_admit(i, req)`` / ``on_retire(i, req)``,
fired exactly once per occupancy at every retirement site (serial
advance, planned tick_advance retirement, surprise eos in finalize).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Optional

POLICIES = ("fcfs", "spf", "deadline")


@dataclasses.dataclass
class Request:
    prompt: list
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    rid: int = -1
    # SLO inputs (open-loop traffic): absolute completion deadline on the
    # ``time.monotonic`` clock, consumed by the "deadline" policy.
    deadline_s: Optional[float] = None
    # filled by the engine:
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    # True when the engine's tick budget expired with this request still
    # queued or mid-flight (``DecodeEngine.run``): the completion is
    # partial, NOT a normal finish.
    truncated: bool = False
    # Lifecycle timestamps (``time.monotonic`` seconds), threaded through
    # for TTFT / per-token latency measurement under open-loop traffic:
    arrival_s: Optional[float] = None       # stamped at submit()/place()
    first_token_s: Optional[float] = None   # first generated token lands
    finish_s: Optional[float] = None        # retirement
    # Admission wave at which the request joined the queue — the aging
    # clock for the spf policy (waves, not wall seconds: deterministic).
    queued_wave: int = 0

    @property
    def n_prompt(self):
        return len(self.prompt)

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token, when both stamps exist."""
        if self.arrival_s is None or self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean per-token latency AFTER the first token (time-per-output-
        token) — None until finished or with fewer than two tokens."""
        if self.first_token_s is None or self.finish_s is None:
            return None
        if len(self.generated) < 2:
            return None
        return ((self.finish_s - self.first_token_s)
                / (len(self.generated) - 1))


@dataclasses.dataclass
class Slot:
    req: Optional[Request] = None
    pos: int = 0              # tokens consumed (prompt + generated)

    @property
    def active(self):
        return self.req is not None and not self.req.done

    def next_token(self) -> int:
        r = self.req
        if self.pos < r.n_prompt:
            return r.prompt[self.pos]
        return r.generated[-1]

    @property
    def prefilling(self) -> bool:
        # the step that consumes prompt token n_prompt-1 emits the first
        # generated token, so "prefilling" = pos < n_prompt - 1
        return self.pos < self.req.n_prompt - 1


class Scheduler:
    """Queue + slot pool.  The engine asks it who to admit, feeds it the
    sampled token per slot per tick, and it decides retirement."""

    def __init__(self, n_slots: int, max_seq: int, *, policy: str = "fcfs"):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; choices: {POLICIES}")
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.policy = policy
        self.slots = [Slot() for _ in range(n_slots)]
        self.queue: collections.deque = collections.deque()
        self.finished: list = []
        self._rid = itertools.count()
        # Admission-wave counter: bumped once per admit() call.  The spf
        # aging clock — a queued request's effective prompt length decays
        # by (wave - queued_wave), so nothing starves.
        self._wave = 0
        # Cache-layer hooks (wired by the engine for the paged path):
        self.admission_gate = None     # (req) -> bool: may admit now?
        self.on_admit = None           # (slot_index, req): slot occupied
        self.on_retire = None          # (slot_index, req): slot freed
        # Feasibility hook, consulted at SUBMIT time: (req) -> error
        # string, or None when some future pool state can admit the
        # request.  The paged layout wires it to the allocator's
        # whole-pool check — a reservation larger than the TOTAL pool
        # would pass the static max_seq validation yet be gated out every
        # wave, so run() would spin all max_ticks doing nothing.
        self.submit_gate = None

    # -- submission -----------------------------------------------------------
    def new_rid(self) -> int:
        """The next request id: the one place ids are handed out."""
        return next(self._rid)

    def submit(self, req: Request) -> int:
        req.rid = self.new_rid()
        if req.arrival_s is None:
            req.arrival_s = time.monotonic()
        if req.n_prompt < 1:
            raise ValueError(f"req {req.rid}: empty prompt")
        if req.n_prompt + max(req.max_new_tokens, 0) > self.max_seq:
            raise ValueError(
                f"req {req.rid}: prompt ({req.n_prompt}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds engine max_seq "
                f"({self.max_seq})")
        if self.submit_gate is not None:
            reason = self.submit_gate(req)
            if reason:
                # Infeasible under ANY pool state (not just the current
                # one): admitting it is impossible, so queuing it would
                # gate out every future admission wave — reject loudly
                # at the submission boundary instead.
                raise ValueError(f"req {req.rid}: {reason}")
        if req.max_new_tokens <= 0:
            # Degenerate request: nothing to generate.  Retire immediately
            # with an empty completion instead of occupying a slot (the old
            # engine admitted it and could pin the slot forever when the
            # prompt ended at the max_seq boundary).
            req.done = True
            req.finish_s = time.monotonic()
            self.finished.append(req)
            return req.rid
        req.queued_wave = self._wave
        self.queue.append(req)
        return req.rid

    def effective_prompt_len(self, req: Request) -> int:
        """The spf admission key: prompt length minus the aging credit
        (one token per admission wave spent queued, floored at 0).  A
        long prompt's effective length reaches 0 after at most
        ``n_prompt`` waves, so sustained short-request arrivals can only
        delay it a bounded number of admissions — the starvation fix."""
        return max(0, req.n_prompt - (self._wave - req.queued_wave))

    def _next_index(self) -> int:
        """Queue index of the request the policy would admit next."""
        if self.policy == "spf":
            return min(range(len(self.queue)),
                       key=lambda i: (self.effective_prompt_len(
                           self.queue[i]), self.queue[i].rid))
        if self.policy == "deadline":
            inf = float("inf")
            return min(range(len(self.queue)),
                       key=lambda i: (
                           self.queue[i].deadline_s
                           if self.queue[i].deadline_s is not None else inf,
                           self.queue[i].rid))
        return 0

    def _pop(self, at: int) -> Request:
        self.queue.rotate(-at)
        req = self.queue.popleft()
        self.queue.rotate(at)
        return req

    # -- per-tick phases ------------------------------------------------------
    def admit(self) -> list:
        """Fill free slots from the queue; returns newly occupied indices.

        Each candidate is checked against the ``admission_gate`` before
        leaving the queue; a gated-out candidate (e.g. not enough free KV
        blocks for its reservation) stays queued and stops this wave —
        admitting someone behind it would reorder arrivals.
        """
        self._wave += 1
        admitted = []
        for i, slot in enumerate(self.slots):
            if slot.active or not self.queue:
                continue
            at = self._next_index()
            if (self.admission_gate is not None
                    and not self.admission_gate(self.queue[at])):
                break
            req = self._pop(at)
            self.slots[i] = Slot(req=req, pos=0)
            if self.on_admit is not None:
                self.on_admit(i, req)
            admitted.append(i)
        return admitted

    @property
    def active_indices(self) -> list:
        return [i for i, s in enumerate(self.slots) if s.active]

    def has_work(self) -> bool:
        return bool(self.queue) or any(s.active for s in self.slots)

    def advance_chunk(self, i: int, n: int):
        """Consume ``n`` prompt tokens of slot ``i`` in one chunked-prefill
        dispatch — position bookkeeping only, no emission.  The chunk must
        stay strictly inside the prompt: the chunk that consumes prompt
        token ``n_prompt - 1`` emits the first generated token, so the
        engine sizes the final chunk one short and hands the closing token
        to ``advance`` (reusing all retirement logic).
        """
        s = self.slots[i]
        assert n >= 0 and s.pos + n < s.req.n_prompt, \
            f"chunk overruns prompt: pos={s.pos} n={n} " \
            f"n_prompt={s.req.n_prompt}"
        s.pos += n

    def place(self, req: Request, i: int):
        """Occupy free slot ``i`` with a request whose prompt was already
        prefilled OUTSIDE the engine (the prefill->insert->generate API):
        the slot starts at ``pos = n_prompt - 1`` — the position the
        legacy path reaches when it consumes the last prompt token — and
        the engine records the externally sampled first token via
        ``advance``.  Fires ``on_admit`` like a queue admission so cache
        tenancy hooks see exactly one occupy per occupancy."""
        if self.slots[i].active:
            raise ValueError(f"slot {i} is occupied")
        if req.rid < 0:
            req.rid = self.new_rid()
        if req.arrival_s is None:
            req.arrival_s = time.monotonic()
        self.slots[i] = Slot(req=req, pos=req.n_prompt - 1)
        if self.on_admit is not None:
            self.on_admit(i, req)

    def prefill_queue(self) -> list:
        """Active slots still consuming their prompt, in the order the
        admission policy would serve them: fcfs by arrival (rid), spf by
        fewest prompt tokens REMAINING (the chunked analog of
        shortest-prompt-first) with rid as the tiebreak."""
        pending = [i for i, s in enumerate(self.slots)
                   if s.active and s.pos < s.req.n_prompt]
        if self.policy == "spf":
            return sorted(pending, key=lambda i: (
                self.slots[i].req.n_prompt - self.slots[i].pos,
                self.slots[i].req.rid))
        if self.policy == "deadline":
            inf = float("inf")
            return sorted(pending, key=lambda i: (
                self.slots[i].req.deadline_s
                if self.slots[i].req.deadline_s is not None else inf,
                self.slots[i].req.rid))
        return sorted(pending, key=lambda i: self.slots[i].req.rid)

    def advance(self, i: int, token: int):
        """Post-step bookkeeping for slot ``i`` given its sampled ``token``.

        Returns the retired ``Request`` if the slot finished, else None.
        """
        s = self.slots[i]
        emitted = not s.prefilling
        s.pos += 1
        if not emitted:
            return None
        r = s.req
        r.generated.append(int(token))
        if r.first_token_s is None:
            r.first_token_s = time.monotonic()
        hit_eos = r.eos_id is not None and int(token) == r.eos_id
        if (len(r.generated) >= r.max_new_tokens or hit_eos
                or s.pos + 1 >= self.max_seq):
            r.done = True
            r.finish_s = time.monotonic()
            self.finished.append(r)
            self.slots[i] = Slot()
            if self.on_retire is not None:
                self.on_retire(i, r)
            return r
        return None

    def advance_multi(self, i: int, tokens) -> tuple:
        """Record a speculative window's accepted tokens for slot ``i``,
        one at a time through :meth:`advance` so every retirement rule
        (eos, max_new, the max_seq boundary) applies at the exact token
        it lands on — which may be MID-window.  Recording stops at the
        first retirement; later tokens in the window are discarded (the
        engine already rolled their cache writes back by frontier
        truncation, so nothing of them survives).  Returns
        ``(n_recorded, retired_request_or_None)``."""
        n = 0
        for t in tokens:
            retired = self.advance(i, t)
            n += 1
            if retired is not None:
                return n, retired
        return n, None

    # -- overlapped (double-buffered) tick protocol ---------------------------
    # The engine's O4+ path splits ``advance`` in two so the host can do
    # slot bookkeeping while the device computes: retirements decided by
    # token COUNT or the max_seq boundary are known the moment the step is
    # dispatched — only an eos hit needs the actual token.  ``tick_advance``
    # runs at dispatch time, frees the count-retired slots (so the
    # overlapped admission can refill them under the running step), and
    # ``finalize`` completes the bookkeeping when the tokens arrive.

    def tick_advance(self, active: list) -> list:
        """Advance positions for this tick; plan count/boundary retirements.

        Returns emissions ``[(slot_index, request, planned_retire)]`` — the
        slots whose sampled token must be recorded at ``finalize``.
        """
        out = []
        for i in active:
            s = self.slots[i]
            emitted = not s.prefilling
            s.pos += 1
            if not emitted:
                continue
            r = s.req
            # Emission count from position arithmetic, NOT len(generated):
            # with the pipelined engine, finalize (which appends to
            # generated) trails the dispatch frontier, so the list is
            # stale here.  After the increment, this tick's emission is
            # number ``pos - n_prompt + 1``.
            n_emitted = s.pos - r.n_prompt + 1
            planned = (n_emitted >= r.max_new_tokens
                       or s.pos + 1 >= self.max_seq)
            if planned:
                self.slots[i] = Slot()      # free under the running step
                if self.on_retire is not None:
                    # Blocks freed here may be reallocated by the very
                    # next admit(): the in-flight step still scatters the
                    # retiree's final token into them, but a new tenant
                    # only ever reads positions it has itself written
                    # (everything else is masked), so the stale write is
                    # unobservable.
                    self.on_retire(i, r)
            out.append((i, r, planned))
        return out

    def finalize(self, emissions: list, toks):
        """Record the device's tokens for ``tick_advance``'s emissions;
        complete planned retirements and surprise eos stops."""
        for i, r, planned in emissions:
            if r.done:
                # stale emission: the request hit eos in an earlier tick
                # but the pipelined engine had already dispatched this
                # one — its token is discarded, not recorded.
                continue
            tok = int(toks[i])
            r.generated.append(tok)
            if r.first_token_s is None:
                r.first_token_s = time.monotonic()
            hit_eos = r.eos_id is not None and tok == r.eos_id
            if planned or hit_eos:
                r.done = True
                r.finish_s = time.monotonic()
                self.finished.append(r)
                if not planned and self.slots[i].req is r:
                    self.slots[i] = Slot()
                    if self.on_retire is not None:
                        self.on_retire(i, r)
