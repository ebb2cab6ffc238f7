"""repro_torch.serving — request-level serving: schedulers, slots, pages,
the prefix cache, fault injection and the P/D role split, metrics (the
PyTorch counterpart of ``repro.serving``, with the same exports)."""
from repro_torch.serving.disagg import DisaggregatedEngine
from repro_torch.serving.engine import (SCHEDULERS, ContinuousEngine,
                                        StaticEngine, decode_lockstep,
                                        make_engine)
from repro_torch.serving.faults import (FAULT_KINDS, Fault, FaultInjector,
                                        FaultPlan, InjectedFault,
                                        resolve_fault_plan)
from repro_torch.serving.paged import PagedEngine
from repro_torch.serving.pages import (PageAllocator, PoolInvariantError,
                                       pages_needed)
from repro_torch.serving.prefix import RadixCache
from repro_torch.serving.request import (OUTCOMES, Request, RequestMetrics,
                                         ServeReport, SimClock, WallClock)
from repro_torch.serving.roles import (DecodeWorker, PageHandoff,
                                       PrefillWorker, RequestQueue,
                                       Scheduler, prefill_owner)

__all__ = [
    "FAULT_KINDS",
    "Fault",
    "FaultInjector",
    "FaultPlan",
    "InjectedFault",
    "OUTCOMES",
    "SCHEDULERS",
    "ContinuousEngine",
    "DecodeWorker",
    "DisaggregatedEngine",
    "PagedEngine",
    "PageAllocator",
    "PageHandoff",
    "PoolInvariantError",
    "PrefillWorker",
    "RadixCache",
    "RequestQueue",
    "Scheduler",
    "StaticEngine",
    "decode_lockstep",
    "make_engine",
    "pages_needed",
    "prefill_owner",
    "resolve_fault_plan",
    "Request",
    "RequestMetrics",
    "ServeReport",
    "SimClock",
    "WallClock",
]
