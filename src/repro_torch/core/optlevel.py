"""The paper's best-effort refinement steps as a config (port copy).

A copy of the framework-free parts of ``repro/core/optlevel.py`` that the
serving slice and the paper layer (cost model, guideline, autotuner,
MachSuite, the tiled matmul) read: ``Step``, ``STEP_ORDER``, the
cumulative ``LADDER``, ``OptLevel`` and the serving knobs of
``BestEffortConfig``.  Level semantics are the
reference's:

  O0  naive             O4  +double buffering (host/device overlap)
  O1  +data caching     O5  +scratchpad reorg (packed slot resets)
  O2  +pipelining       O6  +paged scratchpad (KV blocks + tables)
  O3  +PE duplication   O7  +speculative decoding

The port serves every level on one device (O3 records its degree
clipped to that device; O0/O1 run the un-pipelined per-request loop).
"""

from __future__ import annotations

import dataclasses
import enum


class Step(enum.Enum):
    """One refinement step (Table 1 of the paper, plus two serving
    extensions)."""

    DATA_CACHING = "explicit_data_caching"
    PIPELINING = "customized_pipelining"
    PE_DUPLICATION = "pe_duplication"
    DOUBLE_BUFFERING = "double_buffering"
    SCRATCHPAD_REORG = "scratchpad_reorganization"
    PAGED_SCRATCHPAD = "paged_scratchpad"
    SPECULATIVE = "speculative_decoding"


STEP_ORDER = (
    Step.DATA_CACHING,
    Step.PIPELINING,
    Step.PE_DUPLICATION,
    Step.DOUBLE_BUFFERING,
    Step.SCRATCHPAD_REORG,
)

# OptLevel n enables LADDER[:n].
LADDER = STEP_ORDER + (Step.PAGED_SCRATCHPAD, Step.SPECULATIVE)


class OptLevel(enum.IntEnum):
    O0 = 0
    O1 = 1
    O2 = 2
    O3 = 3
    O4 = 4
    O5 = 5
    O6 = 6
    O7 = 7

    @property
    def steps(self) -> tuple:
        return LADDER[: int(self)]

    def has(self, step: Step) -> bool:
        return step in self.steps


@dataclasses.dataclass(frozen=True)
class BestEffortConfig:
    """Serving knobs of the ladder (defaults as in the reference).

    ``pe`` is the PE-duplication degree (clipped to the one device the
    port runs on); ``n_buffers`` the O4 host buffer ring; ``kv_block_size``
    / ``kv_pool_blocks`` the O6 pool geometry (0 blocks = one full
    ``max_seq`` reservation per slot); ``paged_attn`` the O6 attention
    implementation ("gather" re-materializes a dense view per tick,
    "kernel" runs the CUDA paged-decode kernel on the pool);
    ``prefill_chunk`` > 0 asks for chunked prefill; ``draft_model`` /
    ``draft_k`` name the O7 drafter arch and its window (no drafter,
    ``draft_k == 0`` or a stochastic sampler leave O7 decoding plainly,
    recorded in ``engine.spec_mode``); ``kv_dtype`` the stored pool
    dtype.
    """

    level: OptLevel = OptLevel.O5
    pe: int = 8
    n_buffers: int = 3
    kv_block_size: int = 16
    kv_pool_blocks: int = 0
    paged_attn: str = "gather"
    prefill_chunk: int = 0
    draft_model: str = ""
    draft_k: int = 4
    kv_dtype: str = "bf16"

    def __post_init__(self):
        # Imported here: ``serving`` imports this module.
        from repro_torch.serving.kvquant import KV_DTYPES
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {self.kv_dtype!r}; "
                             f"choices: {KV_DTYPES}")

    @property
    def effective_pe(self) -> int:
        return self.pe if self.level.has(Step.PE_DUPLICATION) else 1

    @property
    def kv_layout(self) -> str:
        return ("paged" if self.level.has(Step.PAGED_SCRATCHPAD)
                else "contiguous")

    @property
    def effective_buffers(self) -> int:
        return self.n_buffers if self.level.has(Step.DOUBLE_BUFFERING) else 1

