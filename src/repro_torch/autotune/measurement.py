"""One measurement API for the port's tuning surfaces (port copy of
``repro/autotune/measurement.py``).

The paper's refinement loop is *measure -> diagnose -> transform*; this
module owns the "measure" leg: the ``Measurement`` record the closed-loop
tuner (``autotune.tuner``) speaks and the repo-wide roofline-term
arithmetic, here against the card's spec (``core.hw.H100_SXM``).

One backend implements the measure protocol so far:

  * :class:`KernelModelBackend` — the paper's analytic FPGA cost model
    (``core.costmodel``) for MachSuite kernels.  Instant and exact: the
    reference's records, number for number.

The reference's other two backends (``CostTwinBackend``, the lowered-HLO
cost twin of an LM config, and ``ServingBackend``, the measured serving
ladder) are still to port (ROADMAP A20).

A backend exposes::

    initial_state()            -> opaque state (OptLevel)
    applied(state)             -> set[Step] already applied
    candidate_steps(state)     -> steps that could be applied next
    apply(state, step)         -> new state with ``step`` applied
    measure(state)             -> Measurement
    describe(state)            -> short human label ("O3")
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import costmodel
from repro_torch.core.hw import FPGA_2012, H100_SXM, GpuSpec
from repro_torch.core.optlevel import LADDER, OptLevel, Step


@dataclasses.dataclass
class Measurement:
    """One (target, configuration) performance measurement.

    ``total_s`` is the modeled wall time of the candidate — the objective the
    tuner minimizes.  The three roofline terms (plus the offload term for the
    comm-bound filter) are what the guideline diagnoses on.
    """

    target: str                  # "gemm"
    label: str                   # "O2"
    compute_s: float
    memory_s: float
    collective_s: float = 0.0
    offload_s: float = 0.0       # host<->device payload time (PCIe analog)
    baseline_s: float = 0.0      # CPU baseline for the comm-bound filter
    total_s: float = 0.0
    breakdown: dict = dataclasses.field(default_factory=dict)
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Perfect-overlap lower bound: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["dominant"] = self.dominant
        d["step_time_s"] = self.step_time_s
        return d


def roofline_terms(
    flops_per_device: float,
    bytes_per_device: float,
    collective_bytes_per_device: float,
    *,
    chips: int = 1,
    model_flops: float = 0.0,
    fused_bytes_per_device: float = None,
    spec: GpuSpec = H100_SXM,
) -> dict:
    """The repo-wide three-term roofline arithmetic, in one place.

    Per-device work over per-device peak: FLOPs over the bf16 peak, bytes
    over the device-memory rate, collective bytes over one link's rate
    each way.  Returns the ``*_s`` terms plus the derived diagnosis
    fields every harness reports (dominant term, step-time bound,
    roofline fraction); when ``fused_bytes_per_device`` is given, the
    fusion-adjusted view is included as ``*_fused`` fields.
    """
    rec = {
        "compute_s": flops_per_device / spec.peak_bf16_flops,
        "memory_s": bytes_per_device / spec.hbm_bw,
        "collective_s": collective_bytes_per_device / spec.link_bw,
    }
    terms = {k[:-2]: rec[k] for k in ("compute_s", "memory_s", "collective_s")}
    rec["dominant"] = max(terms, key=terms.get)
    rec["step_time_s"] = max(terms.values())
    useful_s = model_flops / (chips * spec.peak_bf16_flops)
    rec["roofline_fraction"] = (
        useful_s / rec["step_time_s"] if rec["step_time_s"] else 0.0)
    total_flops = flops_per_device * chips
    rec["useful_flops_fraction"] = (
        model_flops / total_flops if total_flops else 0.0)
    if fused_bytes_per_device is not None:
        rec["memory_fused_s"] = fused_bytes_per_device / spec.hbm_bw
        fterms = dict(terms, memory=rec["memory_fused_s"])
        rec["dominant_fused"] = max(fterms, key=fterms.get)
        rec["step_time_fused_s"] = max(fterms.values())
        rec["roofline_fraction_fused"] = (
            useful_s / rec["step_time_fused_s"]
            if rec["step_time_fused_s"] else 0.0)
    return rec


# ---------------------------------------------------------------------------
# Cumulative-ladder state machine, shared by every backend whose steps are
# the paper's O0..O5 levels rather than independent knobs.
# ---------------------------------------------------------------------------


class CumulativeLadderState:
    """State is an :class:`OptLevel`.  The ladder is cumulative, so
    "applying" a step means moving to the lowest level that includes it
    (exactly what the paper's iterations do: Iter #3 lands at O5 having
    passed O4).

    ``top_level`` bounds the walk to the steps that exist on this
    surface: the paper's platforms stop at O5.  ``step_universe`` is the
    matching step set, handed to the guideline so it neither recommends a
    rung the surface lacks nor stops before one it has.
    """

    top_level: OptLevel = OptLevel.O5

    @property
    def step_universe(self) -> tuple:
        return LADDER[: int(self.top_level)]

    def initial_state(self) -> OptLevel:
        return OptLevel.O0

    def applied(self, state: OptLevel):
        return set(state.steps)

    def candidate_steps(self, state: OptLevel):
        # The ladder is cumulative, so the only *minimal* move is the next
        # level: offering later steps as candidates would bundle every
        # intervening step into one jump (O0 + scratchpad-reorg == O5) and
        # the frontier would trivially pick the whole ladder in one round.
        if state >= self.top_level:
            return []
        return [LADDER[int(state)]]

    def apply(self, state: OptLevel, step: Step) -> OptLevel:
        return OptLevel(max(int(state), LADDER.index(step) + 1))

    def describe(self, state: OptLevel) -> str:
        return f"O{int(state)}"


# ---------------------------------------------------------------------------
# Backend: analytic cost model (MachSuite kernels, the paper's platform).
# ---------------------------------------------------------------------------


class KernelModelBackend(CumulativeLadderState):
    """Measure MachSuite kernels on the paper's analytic FPGA model.

    Instant, framework-free, exact reproduction of the paper's platform —
    including its resource feedback (Table 6): a level whose requested
    (cache, PE, word-width) configuration over-subscribes the BRAM fabric
    is not a dead end; ``costmodel.fit_resources`` shrinks the knobs,
    re-measures the feasible candidates, and the walk continues at the
    fastest one.  The fit is recorded in ``Measurement.meta['resource']``.
    """

    def __init__(self, profile: costmodel.KernelProfile, *, hw=None,
                 cache_bytes: float = 64 * 1024, pe: int = 128):
        self.profile = profile
        self.hw = hw or FPGA_2012
        self.cache_bytes = cache_bytes
        self.pe = pe

    @property
    def name(self) -> str:
        return self.profile.name

    def measure(self, state: OptLevel) -> Measurement:
        fit = costmodel.fit_resources(
            self.profile, state, self.hw,
            cache_bytes=self.cache_bytes, pe=self.pe)
        t = costmodel.kernel_time(
            self.profile, state, self.hw,
            cache_bytes=fit["cache_bytes"], pe=fit["pe"],
            word_bits=fit["word_bits"])
        return Measurement(
            target=self.profile.name,
            label=self.describe(state),
            compute_s=t["compute_s"],
            memory_s=t["dram_s"],
            offload_s=t["pcie_s"],
            baseline_s=self.profile.cpu_time_s,
            total_s=t["system_s"],
            breakdown=dict(t),
            meta={"backend": "kernel_model", "level": int(state),
                  "resource": fit},
        )
