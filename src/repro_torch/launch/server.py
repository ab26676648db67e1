"""Async traffic front end: serve REQUESTS, not tick loops (port of
``repro/launch/server.py``).

``launch.serve`` drives :class:`~repro_torch.serving.engine.DecodeEngine`
from a closed synchronous loop — build a fixed request list, call
``run()``, read ``finished``.  That shape cannot absorb open-loop traffic
(arrivals do not wait for the batch to drain), cannot stream tokens back
per request, and measures nothing a serving SLO is written against.
:class:`AsyncServer` closes the gap:

  * ``submit()`` enqueues a request into the ENGINE's scheduler queue
    (the scheduler IS the ingress — admission order equals submission
    order, exactly like the synchronous path) and returns a
    :class:`RequestHandle` carrying a per-token ``stream``
    (``asyncio.Queue``), a ``done`` future resolving to the finished
    :class:`~repro_torch.serving.scheduler.Request`, and an optional
    synchronous ``on_token`` callback.
  * A single background task ticks ``engine.step()`` continuously,
    yielding to the event loop between ticks so arrival coroutines
    interleave with decoding; when idle it parks on an event instead of
    spinning.  Everything runs on ONE thread — the engine's host
    bookkeeping is not thread-safe and does not need to be.  Each tick
    reads its tokens back to the host (``.cpu()``), which waits for the
    device, so a request's time stamps (``time.monotonic``) fall after
    the device produced what they stamp; at O4+ a tick's tokens are
    published at the next tick.
  * Greedy tokens are identical to the synchronous ``submit()``/``run()``
    path for the same admission order: the server never reorders the
    scheduler, it only publishes what the tick loop already produced.

The module also owns the OPEN-LOOP measurement vocabulary the autotuner's
traffic mode uses:

  * :func:`make_trace` — deterministic Poisson / bursty arrival traces
    (the reference's draws from ``np.random.default_rng``, so the same
    arguments give the same trace).
  * :func:`replay_trace` / :func:`serve_trace` — fire a trace at a
    server open-loop (arrivals never wait for completions) and collect
    per-request latency records.
  * :func:`latency_metrics` — p50/p99 TTFT, per-token latency (TPOT),
    and goodput-under-SLO: finished requests that met BOTH the TTFT and
    per-token SLOs, per second of replay.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.serving.engine import DecodeEngine
from repro_torch.serving.scheduler import Request

_END = object()          # stream sentinel: request finished


@dataclasses.dataclass
class TokenEvent:
    """One streamed token: its request, value, index in the completion,
    and the publish timestamp (``time.monotonic``)."""
    rid: int
    token: int
    index: int
    t_s: float


class RequestHandle:
    """The caller's view of one in-flight request."""

    def __init__(self, request: Request, loop: asyncio.AbstractEventLoop,
                 on_token: Optional[Callable] = None):
        self.request = request
        self.stream: asyncio.Queue = asyncio.Queue()
        self.done: asyncio.Future = loop.create_future()
        self.on_token = on_token
        self._published = 0

    @property
    def rid(self) -> int:
        return self.request.rid

    async def tokens(self):
        """Async-iterate the streamed :class:`TokenEvent`\\ s until the
        request finishes."""
        while True:
            ev = await self.stream.get()
            if ev is _END:
                return
            yield ev


class AsyncServer:
    """Open-loop front end over a :class:`DecodeEngine`.

    One background task owns the tick loop; ``submit()`` may be called
    from any coroutine on the same event loop.  Use as an async context
    manager, or ``start()``/``stop()`` explicitly::

        async with AsyncServer(engine) as server:
            h = server.submit([1, 2, 3], max_new_tokens=8)
            async for ev in h.tokens():
                ...
            req = await h.done
    """

    def __init__(self, engine: DecodeEngine, *, max_ticks: int = 0):
        self.engine = engine
        # 0 = unbounded; a positive budget bounds a stuck server the way
        # DecodeEngine.run's budget bounds a stuck drain.
        self.max_ticks = int(max_ticks)
        self.ticks = 0
        self._handles: dict = {}        # rid -> RequestHandle
        self._task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._stopping = False

    # -- lifecycle ----------------------------------------------------------
    async def start(self) -> "AsyncServer":
        if self._task is not None:
            raise RuntimeError("server already started")
        self._wake = asyncio.Event()
        self._task = asyncio.get_running_loop().create_task(self._loop())
        return self

    async def stop(self) -> None:
        """Stop ticking.  Outstanding handles get their futures failed —
        a stopped server never resolves silently."""
        self._stopping = True
        if self._wake is not None:
            self._wake.set()
        if self._task is not None:
            await self._task
            self._task = None
        for h in list(self._handles.values()):
            if not h.done.done():
                h.done.set_exception(
                    RuntimeError(f"server stopped with request "
                                 f"{h.rid} unfinished"))
                h.stream.put_nowait(_END)
        self._handles.clear()

    async def __aenter__(self) -> "AsyncServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- submission ---------------------------------------------------------
    def submit(self, prompt, *, max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               on_token: Optional[Callable] = None) -> RequestHandle:
        """Enqueue a request; returns its :class:`RequestHandle`.

        Raises ``ValueError`` exactly like the synchronous
        ``engine.submit`` (static max_seq validation plus the paged
        pool's never-fits submit gate)."""
        if self._task is None or self._stopping:
            raise RuntimeError("server is not running")
        req = Request(prompt=list(prompt), max_new_tokens=max_new_tokens,
                      eos_id=eos_id, deadline_s=deadline_s)
        self.engine.submit(req)         # validates; stamps arrival_s
        handle = RequestHandle(req, asyncio.get_running_loop(),
                               on_token=on_token)
        if req.done:
            # Degenerate (max_new_tokens <= 0): retired at submit with an
            # empty completion — resolve immediately, nothing will tick.
            handle.done.set_result(req)
            handle.stream.put_nowait(_END)
            return handle
        self._handles[req.rid] = handle
        self._wake.set()
        return handle

    async def drain(self) -> None:
        """Wait until every submitted request has finished."""
        pending = [h.done for h in self._handles.values()]
        if pending:
            await asyncio.gather(*pending)

    # -- the tick loop ------------------------------------------------------
    def _publish(self) -> None:
        """Diff each tracked request's ``generated`` against what was
        already streamed and publish the new tokens; resolve finished
        requests.  Reading ``generated`` (not device buffers) keeps this
        correct under the O4 overlapped engine, whose finalize trails
        the dispatch frontier — a token is published the tick its
        bookkeeping lands, identical to the sync path."""
        now = time.monotonic()
        for rid in list(self._handles):
            h = self._handles[rid]
            r = h.request
            gen = r.generated
            while h._published < len(gen):
                ev = TokenEvent(rid=rid, token=gen[h._published],
                                index=h._published, t_s=now)
                h._published += 1
                h.stream.put_nowait(ev)
                if h.on_token is not None:
                    h.on_token(ev)
            if r.done:
                del self._handles[rid]
                h.stream.put_nowait(_END)
                if not h.done.done():
                    h.done.set_result(r)

    async def _loop(self) -> None:
        engine = self.engine
        while not self._stopping:
            if self.max_ticks and self.ticks >= self.max_ticks:
                # Mirror DecodeEngine.run's budget contract: mark the
                # survivors truncated and FAIL their futures — a waiter
                # blocked on `await handle.done` must not hang forever.
                for h in list(self._handles.values()):
                    h.request.truncated = True
                    if not h.done.done():
                        h.done.set_exception(RuntimeError(
                            f"server tick budget ({self.max_ticks}) "
                            f"exhausted with request {h.rid} unfinished"))
                    h.stream.put_nowait(_END)
                self._handles.clear()
                break
            progressed = engine.step()
            if progressed:
                self.ticks += 1
            self._publish()
            if progressed or engine.queue:
                # Yield WITHOUT sleeping: arrival coroutines scheduled
                # for "now" run between ticks, the engine never idles.
                await asyncio.sleep(0)
            else:
                # Idle: park until the next submission (or stop()).
                self._wake.clear()
                await self._wake.wait()


# ---------------------------------------------------------------------------
# Open-loop traces + replay + metrics.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TraceItem:
    """One arrival in an open-loop trace: fire at ``at_s`` (seconds from
    replay start) regardless of what the server has finished."""
    at_s: float
    prompt: list
    max_new_tokens: int
    eos_id: Optional[int] = None
    deadline_s: Optional[float] = None      # relative to arrival


def make_trace(*, n_requests: int, rate: float, seed: int = 0,
               pattern: str = "poisson", vocab: int = 128,
               prompt_len=(2, 12), max_new=(4, 16),
               burst: int = 8, burst_idle_factor: float = 4.0,
               deadline_slack_s: Optional[float] = None) -> list:
    """Deterministic open-loop arrival trace at ``rate`` requests/s.

    ``poisson``: i.i.d. exponential inter-arrivals (the classic open-loop
    model).  ``bursty``: arrivals clump in bursts of ~``burst`` (geometric
    size) separated by idle gaps ``burst_idle_factor`` x longer than the
    intra-burst spacing, mean rate preserved — the pattern that exposes
    admission-policy starvation (a burst of shorts convoys a long).
    ``deadline_slack_s`` attaches per-request completion deadlines
    (arrival + slack) for the "deadline" policy.
    """
    if pattern not in ("poisson", "bursty"):
        raise ValueError(f"unknown trace pattern {pattern!r}")
    if rate <= 0:
        raise ValueError(f"rate must be > 0 (got {rate})")
    rng = np.random.default_rng(seed)
    mean_gap = 1.0 / rate
    if pattern == "poisson":
        gaps = rng.exponential(mean_gap, n_requests)
    else:
        # Burst sizes ~ Geometric(1/burst); short gaps inside a burst,
        # one long gap between bursts, scaled so the MEAN gap (and thus
        # the offered rate) matches the poisson trace.
        short = mean_gap / burst_idle_factor
        gaps, left = [], 0
        while len(gaps) < n_requests:
            if left == 0:
                left = int(rng.geometric(1.0 / burst))
                n_long = max(1, n_requests // burst)
                long_total = mean_gap * n_requests - short * (
                    n_requests - n_long)
                gaps.append(rng.exponential(
                    max(long_total / n_long, short)))
            else:
                gaps.append(short)
            left -= 1
        gaps = np.asarray(gaps[:n_requests])
    at = np.cumsum(gaps)
    items = []
    for k in range(n_requests):
        plen = int(rng.integers(*prompt_len))
        items.append(TraceItem(
            at_s=float(at[k]),
            prompt=rng.integers(1, vocab, plen).tolist(),
            max_new_tokens=int(rng.integers(*max_new)),
            deadline_s=deadline_slack_s))
    return items


async def replay_trace(server: AsyncServer, trace: list, *,
                       time_scale: float = 1.0) -> list:
    """Fire ``trace`` at ``server`` OPEN-LOOP — each arrival waits for
    its timestamp (scaled by ``time_scale``), never for completions —
    then await every request and return the finished ``Request``s (in
    submission order).  ``time_scale < 1`` compresses the trace."""
    t0 = time.monotonic()
    handles = []
    for item in trace:
        delay = item.at_s * time_scale - (time.monotonic() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        deadline = (time.monotonic() + item.deadline_s
                    if item.deadline_s is not None else None)
        handles.append(server.submit(
            item.prompt, max_new_tokens=item.max_new_tokens,
            eos_id=item.eos_id, deadline_s=deadline))
    return list(await asyncio.gather(*(h.done for h in handles)))


def serve_trace(engine: DecodeEngine, trace: list, *,
                time_scale: float = 1.0, max_ticks: int = 0) -> dict:
    """Synchronous convenience: spin up an :class:`AsyncServer` on a
    fresh event loop, replay ``trace``, tear down.  Returns
    ``{"finished": [...], "makespan_s": float, "ticks": int}``."""

    async def _run():
        t0 = time.monotonic()
        async with AsyncServer(engine, max_ticks=max_ticks) as server:
            finished = await replay_trace(server, trace,
                                          time_scale=time_scale)
            return {"finished": finished,
                    "makespan_s": time.monotonic() - t0,
                    "ticks": server.ticks}

    return asyncio.run(_run())


def _pct(xs: list, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


def latency_metrics(finished: list, *, makespan_s: float,
                    ttft_slo_s: float = 0.5,
                    tpot_slo_s: float = 0.1) -> dict:
    """Open-loop serving metrics over finished ``Request``s.

    TTFT = first token - arrival (queueing + prefill); TPOT = mean
    per-token latency after the first.  ``goodput_rps`` counts only
    requests meeting BOTH SLOs (and, when a request carries a
    ``deadline_s``, finishing by it), per second of replay — the number
    a capacity plan is written against, where raw throughput rewards a
    server that strands its tail.
    """
    ttfts = [r.ttft_s for r in finished if r.ttft_s is not None]
    tpots = [r.tpot_s for r in finished if r.tpot_s is not None]
    tokens = sum(len(r.generated) for r in finished)

    def _good(r) -> bool:
        if r.truncated or r.ttft_s is None:
            return False
        if r.ttft_s > ttft_slo_s:
            return False
        if r.tpot_s is not None and r.tpot_s > tpot_slo_s:
            return False
        if r.deadline_s is not None and r.finish_s is not None:
            return r.finish_s <= r.deadline_s
        return True

    good = sum(1 for r in finished if _good(r))
    span = max(makespan_s, 1e-9)
    return {
        "requests": len(finished),
        "tokens": tokens,
        "makespan_s": makespan_s,
        "throughput_rps": len(finished) / span,
        "tok_per_s": tokens / span,
        "ttft_p50_s": _pct(ttfts, 50),
        "ttft_p99_s": _pct(ttfts, 99),
        "tpot_p50_s": _pct(tpots, 50),
        "tpot_p99_s": _pct(tpots, 99),
        "slo_ttft_s": ttft_slo_s,
        "slo_tpot_s": tpot_slo_s,
        "good_requests": good,
        "goodput_rps": good / span,
        "goodput_frac": good / len(finished) if finished else 0.0,
    }
