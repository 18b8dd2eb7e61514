"""graftlint and graftrace for the port's threaded plane, and the memory
planner.

- **Static** (stdlib ``ast``): lock-discipline rules and the
  ``unbounded-cache`` rule over the source tree, with inline
  ``# graftlint: ignore[rule-id] -- rationale`` suppressions and a
  checked-in ``baseline.json`` for grandfathered findings (empty: the
  port is clean). CLI: ``python -m p2pnetwork_tpu_torch.analysis
  p2pnetwork_tpu_torch/`` — exit 0 means no new findings.

- **Dynamic**: graftrace (:mod:`p2pnetwork_tpu_torch.analysis.race`,
  ``python -m p2pnetwork_tpu_torch.analysis.race``) explores seeded
  deterministic schedules over the :mod:`p2pnetwork_tpu_torch.concurrency`
  seam with vector-clock happens-before race detection. Not imported
  here (it loads scenario modules); its findings flow through this
  package's Finding/baseline machinery.

- The memory planner (``ir/capacity.py``), which prices the serving
  program's device memory.

The JAX package's compile-counting ``retrace_guard`` and its IR audits
read JAX programs, which the port does not have.
"""

from p2pnetwork_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    SEVERITIES,
    all_rules,
    analyze_paths,
    analyze_source,
    apply_baseline,
    default_baseline_path,
    load_baseline,
    write_baseline,
)

__all__ = [
    "Finding", "SEVERITIES", "all_rules", "analyze_paths", "analyze_source",
    "apply_baseline", "default_baseline_path", "load_baseline",
    "write_baseline",
]
