"""repro_torch.bench — the port's benchmark harness, the counterpart of
``repro.bench``:

* :mod:`repro_torch.bench.record` — :class:`BenchRecord`, the typed result
  every benchmark emits (JSONL + CSV serializable);
* :mod:`repro_torch.bench.scenario` — the registry of named, tagged
  scenarios whose (arch x shape x mesh x knobs) sweeps are declared as
  :class:`Workload` data;
* :mod:`repro_torch.bench.runner` — the single runner owning timing (the
  device synchronised before each timer stops), fail-soft error capture,
  and result sinks;
* :mod:`repro_torch.bench.baseline` / :mod:`repro_torch.bench.compare` —
  blessed per-(backend, env-fingerprint) baselines under
  ``results/baselines_torch/`` and the noise-aware regression gate behind
  ``python -m repro_torch.bench --compare``;
* :mod:`repro_torch.bench.suites` — the scenarios (imported by
  ``python -m repro_torch.bench``, not by this package).
"""
from repro_torch.bench.baseline import (bless, fingerprint,  # noqa: F401
                                        fingerprint_compatible,
                                        load_baselines)
from repro_torch.bench.compare import (CompareReport,  # noqa: F401
                                       CompareResult, Thresholds,
                                       append_trajectory, compare_record,
                                       compare_records, read_trajectory)
from repro_torch.bench.record import (CSV_HEADER, BenchRecord,  # noqa: F401
                                      env_fingerprint, read_jsonl,
                                      write_jsonl)
from repro_torch.bench.runner import (BenchRunner,  # noqa: F401
                                      CsvStdoutSink, JsonlSink, ListSink,
                                      RunSummary, ScenarioTimeout,
                                      TimingStats, timeit_us)
from repro_torch.bench.scenario import (BENCH_MESH, BENCH_SHAPE,  # noqa: F401
                                        REGISTRY, Scenario, Workload, groups,
                                        mesh_str, names, only_matches,
                                        register, scenario, select,
                                        unregister)

__all__ = [
    "BENCH_MESH", "BENCH_SHAPE", "BenchRecord", "BenchRunner", "CSV_HEADER",
    "CompareReport", "CompareResult", "CsvStdoutSink", "JsonlSink",
    "ListSink", "REGISTRY", "RunSummary", "Scenario", "ScenarioTimeout",
    "Thresholds", "TimingStats", "Workload", "append_trajectory", "bless",
    "compare_record", "compare_records", "env_fingerprint", "fingerprint",
    "fingerprint_compatible", "groups", "load_baselines", "mesh_str",
    "names", "only_matches", "read_jsonl", "read_trajectory", "register",
    "scenario", "select", "timeit_us", "unregister",
    "write_jsonl",
]
