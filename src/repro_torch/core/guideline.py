"""The best-effort guideline: bottleneck -> recommended next step (port
copy of ``repro/core/guideline.py``).

This encodes the paper's decision procedure (§3-§6):

  * Before anything: the communication-bound filter (paper Table 5) — if
    host<->device (on several cards: the interconnect's) time rivals the useful compute time,
    the kernel is "non-acceleratable"; stop (BFS/SPMV analog).
  * DRAM/memory-dominated  -> explicit data caching; if caching is already
    applied -> double buffering, then scratchpad reorganization (the paper's
    Iter #3 order).
  * Compute-dominated      -> customized pipelining, then PE duplication
    (the paper's Iter #2 order).
  * Resource feedback (paper Table 6): strategies that need <10% of a
    resource are always applied; conflicts resolve by shrinking cache size
    first (paper: 64 KB suffices), then PE count.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.optlevel import STEP_ORDER, OptLevel, Step


@dataclasses.dataclass
class Recommendation:
    step: Step | None
    reason: str
    stop: bool = False

    def __str__(self) -> str:
        head = "STOP" if self.stop else (self.step.value if self.step else "done")
        return f"{head}: {self.reason}"


# Communication-bound threshold: paper Table 5 rejects BFS (0.8) and
# SPMV (1.3) whose PCIe time is within ~1x of CPU runtime, and accepts
# KMP at 5.9e-2.  We use 0.5 as the cut, as the paper's accepted kernels
# are all <0.06 and rejected ones >0.8.
COMM_BOUND_THRESHOLD = 0.5


def comm_bound_filter(offload_s: float, baseline_s: float) -> Recommendation | None:
    """Paper Table 5: reject kernels whose offload cost rivals the baseline."""
    if baseline_s <= 0:
        return None
    ratio = offload_s / baseline_s
    if ratio > COMM_BOUND_THRESHOLD:
        return Recommendation(
            None,
            f"offload/baseline = {ratio:.2f} > {COMM_BOUND_THRESHOLD}: "
            "communication-bound, not acceleratable on this platform "
            "(the paper's BFS/SPMV case)",
            stop=True,
        )
    return None


def recommend(
    *,
    level: OptLevel = None,
    applied=None,
    compute_s: float,
    memory_s: float,
    collective_s: float = 0.0,
    offload_s: float = 0.0,
    baseline_s: float = 0.0,
    steps=None,
) -> Recommendation:
    """Given the current breakdown, pick the paper's next step.

    The applied-step set comes from ``level`` (the cumulative FPGA ladder)
    or, for surfaces whose steps are independent knobs (the LM cost-twin
    backend of the reference's autotuner), from ``applied`` directly.

    ``collective_s`` generalizes the paper's PCIe term to a multi-device
    mesh: a dominant collective term is attacked with the O4/O5 analogs
    (overlap, compressed/wider-word collectives) rather than more PEs.

    ``steps`` is the step universe available on the surface being tuned —
    default the paper's five (``STEP_ORDER``).  The serving runtime passes
    its extended ladder so the paged-scratchpad rung (memory-system step,
    tried after wide-word reorg, exactly the paper's Iter #3 escalation)
    is recommended there and nowhere else.
    """
    comm = comm_bound_filter(offload_s, baseline_s)
    if comm is not None:
        return comm

    universe = tuple(steps) if steps is not None else STEP_ORDER
    if applied is None:
        if level is None:
            raise TypeError("recommend() needs `level` or `applied`")
        applied = set(level.steps)
    else:
        applied = set(applied)
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)

    if dominant == "memory":
        order = (Step.DATA_CACHING, Step.DOUBLE_BUFFERING,
                 Step.SCRATCHPAD_REORG, Step.PAGED_SCRATCHPAD)
        why = "memory term dominates (paper Iter #1/#3: DRAM access bound)"
    elif dominant == "compute":
        order = (Step.PIPELINING, Step.PE_DUPLICATION)
        why = "compute term dominates (paper Iter #2: frequency-deficit bound)"
    else:
        order = (Step.DOUBLE_BUFFERING, Step.SCRATCHPAD_REORG,
                 Step.PAGED_SCRATCHPAD, Step.PE_DUPLICATION)
        why = ("collective term dominates (mesh generalization of the PCIe "
               "column: overlap it, then shrink it by packing)")

    for step in order:
        if step in universe and step not in applied:
            return Recommendation(step, why)
    # Everything that attacks the dominant term is already applied.
    for step in universe:
        if step not in applied:
            return Recommendation(
                step, f"dominant-term steps exhausted; next ladder step ({why})"
            )
    if universe == STEP_ORDER:
        reason = ("all five steps applied — the paper stops here "
                  "(best-effort, not necessarily optimal)")
    else:
        reason = (f"all {len(universe)} ladder steps applied — top of this "
                  "surface's ladder (best-effort, not necessarily optimal)")
    return Recommendation(None, reason, stop=True)
