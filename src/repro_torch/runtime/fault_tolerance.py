"""Fault tolerance: heartbeat, resilient step loop, fault injection.

The port's own copy of ``repro/runtime/fault_tolerance.py`` (a module
with no framework in it, kept here because the port imports nothing of
the reference).

At 1000+-node scale the question is not *if* a step fails but *when*.  The
runner below wraps any step callable with:

  * **checkpoint/restart** — on failure, restore the latest checkpoint and
    resume; with the deterministic data pipeline (``data/pipeline.py``)
    the recovered run is bitwise-identical to an unfailed one (tested).
  * **bounded retries** — per-step transient retry (preemption, DMA error)
    with exponential backoff before escalating to restore.
  * **heartbeat** — a watchdog thread that flags a hung step (collective
    deadlock, straggler host) after ``timeout_s``; the step is then treated
    as failed.  On real fleets the supervisor would kill+restart the
    process; here the deadline fires an exception in-loop.
  * **straggler mitigation** — per-step deadline accounting: steps whose
    wall time exceeds ``straggler_factor`` x the running median are logged
    and counted (the scheduler's signal for hot-swapping a slow host).

``FaultInjector`` deterministically raises at chosen steps to let the tests
exercise all paths without real hardware faults.
"""

from __future__ import annotations

import threading
import time


class StepFailure(RuntimeError):
    pass


class HeartbeatTimeout(StepFailure):
    pass


class FaultInjector:
    """Deterministically fail chosen (step, attempt) pairs.

    Faults are ONE-SHOT: each key fires once, modelling a real transient
    (a preempted host does not re-fail on the replayed step after
    restore).  Keys are ``(step, attempt)`` pairs or bare ``step`` ints
    (= attempt 0)."""

    def __init__(self, fail_at=(), hang_at=()):
        self.fail_at = set(fail_at)      # {(step, attempt), ...} or {step}
        self.hang_at = set(hang_at)
        self.log: list = []

    def maybe_fail(self, step: int, attempt: int):
        for key in ((step, attempt), step if attempt == 0 else None):
            if key is not None and key in self.fail_at:
                self.fail_at.discard(key)
                self.log.append(("fault", step, attempt))
                raise StepFailure(f"injected fault at step {step} "
                                  f"(attempt {attempt})")
        if step in self.hang_at and attempt == 0:
            self.hang_at.discard(step)
            self.log.append(("hang", step, attempt))
            time.sleep(3600)


class Heartbeat:
    """Watchdog: ``beat()`` regularly or ``expired`` flips true."""

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def beat(self):
        with self._lock:
            self._last = time.monotonic()

    @property
    def expired(self) -> bool:
        with self._lock:
            return (time.monotonic() - self._last) > self.timeout_s

    def check(self):
        if self.expired:
            raise HeartbeatTimeout(
                f"no heartbeat for > {self.timeout_s}s")


class ResilientRunner:
    """Run ``n_steps`` of ``step_fn`` with retry + restore-on-failure.

    step_fn(state, step) -> state          (pure training step + host work)
    save_fn(state, step)                   (checkpoint hook, every ``every``)
    restore_fn() -> (state, step) | None   (latest checkpoint or None)
    """

    def __init__(self, step_fn, *, save_fn=None, restore_fn=None,
                 every: int = 10, max_retries: int = 2,
                 max_restores: int = 3, backoff_s: float = 0.0,
                 straggler_factor: float = 3.0, injector=None):
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.every = every
        self.max_retries = max_retries
        self.max_restores = max_restores
        self.backoff_s = backoff_s
        self.straggler_factor = straggler_factor
        self.injector = injector
        self.events: list = []
        self.step_times: list = []
        self.stragglers: list = []

    def _median_time(self) -> float:
        if not self.step_times:
            return float("inf")
        s = sorted(self.step_times)
        return s[len(s) // 2]

    def run(self, state, *, start_step: int = 0, n_steps: int = 100):
        step = start_step
        restores = 0
        end = start_step + n_steps
        while step < end:
            attempt = 0
            while True:
                try:
                    t0 = time.monotonic()
                    if self.injector is not None:
                        self.injector.maybe_fail(step, attempt)
                    state = self.step_fn(state, step)
                    dt = time.monotonic() - t0
                    med = self._median_time()
                    if (len(self.step_times) >= 5
                            and dt > self.straggler_factor * med):
                        self.stragglers.append((step, dt, med))
                        self.events.append(("straggler", step, dt))
                    self.step_times.append(dt)
                    break
                except StepFailure as e:
                    attempt += 1
                    self.events.append(("failure", step, attempt, str(e)))
                    if attempt <= self.max_retries:
                        if self.backoff_s:
                            time.sleep(self.backoff_s * (2 ** (attempt - 1)))
                        continue
                    # escalate: restore from checkpoint
                    restores += 1
                    if (self.restore_fn is None
                            or restores > self.max_restores):
                        raise
                    restored = self.restore_fn()
                    if restored is None:
                        raise
                    state, step = restored
                    self.events.append(("restore", step))
                    attempt = 0
            step += 1
            if self.save_fn is not None and step % self.every == 0:
                self.save_fn(state, step)
        return state, step
