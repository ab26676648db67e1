"""Closed-loop best-effort autotuner (port of ``repro/autotune``).

Automates the paper's measure -> guideline -> transform -> re-measure cycle
end-to-end (``python -m repro_torch.autotune --kernel gemm``) over the
analytic MachSuite cost model, and walks the serving engine's measured
ladder (``--serve --arch qwen3-8b``).  See ``autotune.measurement`` for
the measurement API and ``autotune.tuner`` for the loop itself.  The
reference's LM cost twin is still to port (ROADMAP A19, A20).
"""

from repro_torch.autotune.measurement import (
    CumulativeLadderState,
    KernelModelBackend,
    Measurement,
    ServingBackend,
    roofline_terms,
    run_serving_workload,
    serving_latency_probe,
    serving_smoke_config,
    serving_workload,
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
    "ServingBackend",
    "TuneResult",
    "TuneRound",
    "autotune",
    "read_trajectory",
    "render_rounds",
    "render_summary",
    "roofline_terms",
    "run_serving_workload",
    "serving_latency_probe",
    "serving_smoke_config",
    "serving_workload",
    "trajectory_path",
    "write_trajectory",
]
