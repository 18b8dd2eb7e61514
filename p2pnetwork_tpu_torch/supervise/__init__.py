"""The supervised execution plane (the port's copy of
``p2pnetwork_tpu/supervise``):

- :class:`~p2pnetwork_tpu_torch.supervise.watchdog.Watchdog` /
  :class:`~p2pnetwork_tpu_torch.supervise.watchdog.StallTimeout` —
  deadline watchdog over heartbeats;
- :class:`~p2pnetwork_tpu_torch.supervise.store.CheckpointStore` —
  atomic, retention-bounded checkpoint directory with corrupt-skip
  resume;
- :class:`~p2pnetwork_tpu_torch.supervise.runner.SupervisedRun` /
  :class:`~p2pnetwork_tpu_torch.supervise.runner.Preempted` — chunked,
  auto-checkpointing, resumable driver of the engine's loops.
- :class:`~p2pnetwork_tpu_torch.supervise.heal.RetryPolicy` /
  :class:`~p2pnetwork_tpu_torch.supervise.heal.Healer` /
  :class:`~p2pnetwork_tpu_torch.supervise.heal.IntegrityViolation` —
  self-healing: end-of-chunk integrity checks plus policy-routed
  rollback-and-retry of detected bad state.
"""

from p2pnetwork_tpu_torch.supervise.heal import (  # noqa: F401
    Healer, IntegrityViolation, RetryPolicy)
from p2pnetwork_tpu_torch.supervise.runner import (  # noqa: F401
    Preempted, SupervisedRun)
from p2pnetwork_tpu_torch.supervise.store import (  # noqa: F401
    CheckpointStore, atomic_write_json)
from p2pnetwork_tpu_torch.supervise.watchdog import (  # noqa: F401
    StallTimeout, Watchdog)

__all__ = ["Watchdog", "StallTimeout", "CheckpointStore", "SupervisedRun",
           "Preempted", "RetryPolicy", "Healer", "IntegrityViolation"]
