"""Serving subsystem of the port: the decode engine on the ladder.

``scheduler`` (admission + slots), ``cache`` (contiguous slot resets,
the O0 rebuild), ``paged`` (the O6 block pool), ``sampler`` (sample on
the device), ``overlap`` (host/device double buffering), ``layout``
(contiguous vs paged strategy) — assembled by ``engine.DecodeEngine``, whose
``prefill`` / ``insert`` / ``generate`` expose the phases directly.
"""

from repro_torch.serving.cache import CacheManager            # noqa: F401
from repro_torch.serving.engine import (                       # noqa: F401
    DecodeEngine, PrefillResult, TickBudgetExceeded)
from repro_torch.serving.layout import (                       # noqa: F401
    ContiguousLayout, KVLayout, PagedLayout, select_layout)
from repro_torch.serving.overlap import HostOverlap, TickBuffers  # noqa: F401
from repro_torch.serving.paged import (                        # noqa: F401
    BlockAllocator, BlockPagingPlan, PagedAllocator, PagedCacheManager)
from repro_torch.serving.sampler import SamplerConfig, make_sampler  # noqa: F401
from repro_torch.serving.scheduler import Request, Scheduler, Slot  # noqa: F401
