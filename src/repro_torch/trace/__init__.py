"""repro_torch.trace -- trace-driven op-level profiling and DAG replay,
the counterpart of ``repro/trace`` under the same exports.

The measure -> compare -> gate loop applied to prediction:

* :mod:`repro_torch.trace.schema`  -- the serializable trace format: a
  DAG of timed :class:`TraceEvent` nodes inside a schema-versioned,
  env-fingerprinted :class:`Trace` (JSON on disk, the reference's
  layout);
* :mod:`repro_torch.trace.capture` -- recorders: the real train step
  (its own timers around the synchronised step plus a per-op breakdown
  from ``core/cost.py``'s count of the same step) and the serving
  engines' prefill/decode dispatches (:class:`TracingClock`, at the
  clock seam: no engine changes);
* :mod:`repro_torch.trace.replay`  -- the critical-path replayer: an
  earliest-start walk over the DAG predicting step time under edits;
* :mod:`repro_torch.trace.whatif`  -- edits (scale an op, re-split the
  mesh) and the trace-calibrated ``mesh_advisor`` bridge.

Validated cell by cell against the measured DP/TP scaling matrix
(``trace_replay/*`` of :mod:`repro_torch.bench.suites.trace`: identity
replay within 25% of each cell's measured median).
"""

from repro_torch.trace.capture import (
    TracingClock,
    capture_matrix_cell,
    capture_train_trace,
    dag_from_cost_summary,
    trace_from_cell_payload,
)
from repro_torch.trace.replay import ReplayResult, replay, toposort
from repro_torch.trace.schema import (
    TRACE_SCHEMA_VERSION,
    Trace,
    TraceError,
    TraceEvent,
    load_trace,
)
from repro_torch.trace.whatif import (
    advise_from_trace,
    predict_split,
    scale_kind,
    scale_op,
    set_cost,
)

__all__ = [
    "TRACE_SCHEMA_VERSION",
    "Trace",
    "TraceError",
    "TraceEvent",
    "TracingClock",
    "ReplayResult",
    "advise_from_trace",
    "capture_matrix_cell",
    "capture_train_trace",
    "dag_from_cost_summary",
    "load_trace",
    "predict_split",
    "replay",
    "scale_kind",
    "scale_op",
    "set_cost",
    "toposort",
    "trace_from_cell_payload",
]
