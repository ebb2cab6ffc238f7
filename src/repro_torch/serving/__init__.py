"""repro_torch.serving — request-level serving: schedulers, slots, pages,
metrics (the PyTorch counterpart of ``repro.serving``)."""
from repro_torch.serving.engine import (SCHEDULERS, ContinuousEngine,
                                        StaticEngine, decode_lockstep,
                                        make_engine)
from repro_torch.serving.paged import PagedEngine
from repro_torch.serving.pages import (PageAllocator, PoolInvariantError,
                                       PoolStats, pages_needed)
from repro_torch.serving.request import (OUTCOMES, Request, RequestMetrics,
                                         ServeReport, SimClock, WallClock)
from repro_torch.serving.roles import (DecodeWorker, PageHandoff,
                                       PrefillWorker, RequestQueue,
                                       Scheduler, prefill_owner)

__all__ = [
    "OUTCOMES",
    "SCHEDULERS",
    "ContinuousEngine",
    "DecodeWorker",
    "PagedEngine",
    "PageAllocator",
    "PageHandoff",
    "PoolInvariantError",
    "PoolStats",
    "PrefillWorker",
    "Request",
    "RequestMetrics",
    "RequestQueue",
    "Scheduler",
    "ServeReport",
    "SimClock",
    "StaticEngine",
    "WallClock",
    "decode_lockstep",
    "make_engine",
    "pages_needed",
    "prefill_owner",
]
