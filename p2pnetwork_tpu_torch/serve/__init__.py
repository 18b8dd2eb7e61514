"""The serving plane (the port's copy of ``p2pnetwork_tpu/serve``, with its
``__all__``): :class:`SimService` (submit / poll / wait / stream / cancel
over the batched message plane, admission pacing, quotas, load shedding,
store trail, journal, epoch fencing), :class:`Standby` failover, and the
seeded traffic generator :func:`generate` / :func:`drive`.
"""

from p2pnetwork_tpu_torch.serve.journal import (
    FSYNC_POLICIES,
    Journal,
    RECORD_KINDS,
)
from p2pnetwork_tpu_torch.serve.service import (
    DurabilityLost,
    FencedEpoch,
    GraphMismatch,
    MemoryBudgetExceeded,
    QueueFull,
    QuotaExceeded,
    Rejected,
    ServiceClosed,
    SimService,
    TERMINAL_STATES,
)
from p2pnetwork_tpu_torch.serve.standby import Standby
from p2pnetwork_tpu_torch.serve.traffic import (
    TrafficPattern,
    TrafficSchedule,
    drive,
    generate,
)

__all__ = [
    "DurabilityLost",
    "FSYNC_POLICIES",
    "FencedEpoch",
    "GraphMismatch",
    "Journal",
    "MemoryBudgetExceeded",
    "QueueFull",
    "QuotaExceeded",
    "RECORD_KINDS",
    "Rejected",
    "ServiceClosed",
    "SimService",
    "Standby",
    "TERMINAL_STATES",
    "TrafficPattern",
    "TrafficSchedule",
    "drive",
    "generate",
]
