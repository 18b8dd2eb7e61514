"""graftrace: deterministic schedule exploration + happens-before race
detection for the seam-routed thread plane (see sched.py and detector.py
module docstrings; the CLI is
``python -m p2pnetwork_tpu_torch.analysis.race``).

Stdlib-only at import; individual scenarios declare their own heavier
dependencies (the supervise and serving scenarios need torch) and report
themselves unavailable instead of crashing the battery.
"""

from p2pnetwork_tpu_torch.analysis.race.detector import (  # noqa: F401
    DEADLOCK_RULE, ERROR_RULE, RACE_RULE, Detector, Shared, guarded_attrs,
    watch,
)
from p2pnetwork_tpu_torch.analysis.race.sched import (  # noqa: F401
    DeadlockError, RunResult, ScheduleBudgetExceeded, Scheduler,
    TraceProvider, explore, load_replay, write_replay,
)

__all__ = [
    "Detector", "Shared", "watch", "guarded_attrs", "explore",
    "Scheduler", "TraceProvider", "RunResult", "DeadlockError",
    "ScheduleBudgetExceeded", "write_replay", "load_replay",
    "RACE_RULE", "DEADLOCK_RULE", "ERROR_RULE",
]
