"""Closed-loop best-effort autotuner (port copy of
``repro/autotune/tuner.py``: the paper's procedure, unattended).

The paper's human drives three iterations of *measure the breakdown -> read
the guideline -> apply one transformation -> re-measure*.  This module closes
that loop: given a measurement backend (``autotune.measurement``), it walks
the candidate space until the guideline says stop, the comm-bound filter
rejects the kernel, or no candidate improves the modeled time.

Two exploration modes:

  * greedy (default) — exactly the paper: one guideline-recommended step per
    round.  Deterministic, minimal measurements.
  * frontier (AutoDSE-style, opt-in) — each round measures every *minimal*
    candidate move the backend offers and keeps the best, so a mis-ranked
    guideline suggestion cannot trap the search.  On the cumulative FPGA
    ladder the only minimal move is the next level, so the frontier
    degrades to a measured one-level-at-a-time walk that stops as soon as
    a level fails to improve.  The guideline still provides the stop
    condition and the diagnosis that is logged.

The reference's third mode, the full-ladder walk of its serving engine,
comes with ``ServingBackend`` (ROADMAP A20).
"""

from __future__ import annotations

import dataclasses

from repro_torch.autotune.measurement import Measurement
from repro_torch.core.guideline import Recommendation, recommend


@dataclasses.dataclass
class TuneRound:
    """One measure->diagnose(->explore) round."""

    round: int
    label: str                   # state label measured this round ("O2")
    applied_step: str            # step taken to reach this state ("" round 0)
    measurement: Measurement
    recommendation: str
    stop: bool
    speedup_vs_start: float
    candidates: list = dataclasses.field(default_factory=list)
    # frontier mode: [(candidate label, total_s), ...] measured this round

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["measurement"] = self.measurement.to_dict()
        return d


@dataclasses.dataclass
class TuneResult:
    target: str
    mode: str                    # greedy | frontier
    rounds: list                 # [TuneRound]
    rejected: bool               # comm-bound filter fired (paper Table 5)

    @property
    def final(self) -> TuneRound:
        return self.rounds[-1]

    @property
    def final_label(self) -> str:
        return self.final.label

    @property
    def final_total_s(self) -> float:
        return self.final.measurement.total_s

    @property
    def final_speedup(self) -> float:
        return self.final.speedup_vs_start

    @property
    def steps_taken(self) -> list:
        return [r.applied_step for r in self.rounds if r.applied_step]

    def to_records(self) -> list:
        """JSONL-ready per-round records (see ``autotune.trajectory``)."""
        out = []
        for r in self.rounds:
            rec = r.to_dict()
            rec.update(target=self.target, mode=self.mode,
                       rejected=self.rejected)
            out.append(rec)
        return out


def _diagnose(backend, state, m: Measurement) -> Recommendation:
    return recommend(
        applied=backend.applied(state),
        compute_s=m.compute_s,
        memory_s=m.memory_s,
        collective_s=m.collective_s,
        offload_s=m.offload_s,
        baseline_s=m.baseline_s,
        # A surface declares its step universe; the paper's platforms
        # stop at the five steps of O5.
        steps=getattr(backend, "step_universe", None),
    )


def autotune(backend, *, frontier: bool = False,
             max_rounds: int = 12) -> TuneResult:
    """Run the closed loop to completion.

    Stops when the guideline stops (all steps applied / comm-bound reject),
    when ``max_rounds`` is exhausted, or — in frontier mode — when no
    remaining candidate improves ``total_s`` (AutoDSE's bottleneck-guided
    pruning: exploring past a non-improving frontier is wasted synthesis).
    """
    state = backend.initial_state()
    m = backend.measure(state)
    t_start = m.total_s
    rounds = []
    applied_step = ""
    rejected = False

    for i in range(max_rounds):
        rec = _diagnose(backend, state, m)
        round_ = TuneRound(
            round=i,
            label=backend.describe(state),
            applied_step=applied_step,
            measurement=m,
            recommendation=str(rec),
            stop=rec.stop,
            speedup_vs_start=t_start / m.total_s if m.total_s else 0.0,
        )
        rounds.append(round_)
        if rec.stop or rec.step is None:
            rejected = rec.stop and "communication-bound" in rec.reason
            break

        if frontier:
            cands = []
            for step in backend.candidate_steps(state):
                cand_state = backend.apply(state, step)
                cand_m = backend.measure(cand_state)
                cands.append((step, cand_state, cand_m))
            round_.candidates = [
                (backend.describe(s), cm.total_s) for _, s, cm in cands]
            best = min(cands, key=lambda c: c[2].total_s)
            if best[2].total_s >= m.total_s:
                round_.recommendation += (
                    " | frontier: no candidate improves; stop")
                round_.stop = True
                break
            step, state, m = best
        else:
            step = rec.step
            state = backend.apply(state, step)
            m = backend.measure(state)
        applied_step = step.value
    else:
        # max_rounds exhausted without a stop verdict: log the final state.
        rec = _diagnose(backend, state, m)
        rounds.append(TuneRound(
            round=max_rounds,
            label=backend.describe(state),
            applied_step=applied_step,
            measurement=m,
            recommendation=str(rec),
            stop=True,
            speedup_vs_start=t_start / m.total_s if m.total_s else 0.0,
        ))

    return TuneResult(
        target=backend.name,
        mode="frontier" if frontier else "greedy",
        rounds=rounds,
        rejected=rejected,
    )
