"""Static analysis of the port: launch contracts, step purity and repo
seams, the counterpart of ``repro.analysis``.

Three layers, one CLI (``python -m repro_torch.analysis``):

* :mod:`repro_torch.analysis.kernel_lint` — each CUDA kernel's launch
  plan (grid, threads, shared memory, cluster) against the H100's limits
  (RK rules);
* :mod:`repro_torch.analysis.graph_audit` — the step functions run once
  under a dispatch mode: host reads, f64 values, steady-state rebuilds
  and launches, collectives, host-device copies (RG rules);
* :mod:`repro_torch.analysis.seams` — AST lint for the serving-seam
  conventions (RS rules).

The rule catalog is :data:`repro_torch.analysis.findings.RULES`. Suppress
a finding with an inline ``# repro: allow=<RULE>`` pragma.
"""

from .findings import RULES, Finding  # noqa: F401
