"""Closed-loop best-effort autotuner (port of ``repro/autotune``).

Automates the paper's measure -> guideline -> transform -> re-measure cycle
end-to-end (``python -m repro_torch.autotune --kernel gemm``) over the
analytic MachSuite cost model.  See ``autotune.measurement`` for the
measurement API and ``autotune.tuner`` for the loop itself.  The
reference's LM cost-twin and serving backends are still to port (ROADMAP
A20).
"""

from repro_torch.autotune.measurement import (
    CumulativeLadderState,
    KernelModelBackend,
    Measurement,
    roofline_terms,
)
from repro_torch.autotune.trajectory import (
    read_trajectory,
    render_rounds,
    render_summary,
    trajectory_path,
    write_trajectory,
)
from repro_torch.autotune.tuner import TuneResult, TuneRound, autotune

__all__ = [
    "CumulativeLadderState",
    "KernelModelBackend",
    "Measurement",
    "TuneResult",
    "TuneRound",
    "autotune",
    "read_trajectory",
    "render_rounds",
    "render_summary",
    "roofline_terms",
    "trajectory_path",
    "write_trajectory",
]
