"""The port's chaos plane (its counterpart of ``p2pnetwork_tpu/chaos``):
seeded, deterministic fault injection for the sockets backend, the device
plane and the serving plane.

- **Sockets** (:mod:`p2pnetwork_tpu_torch.chaos.plane`,
  :mod:`p2pnetwork_tpu_torch.chaos.streams`): :class:`ChaosPlane` wraps a
  :class:`~p2pnetwork_tpu_torch.node.Node`'s connection factory, with the
  sim failures API's names (``kill_nodes`` / ``revive_nodes`` /
  ``cut_links`` / ``partition``) plus the sockets-only faults (latency,
  throttle, frame drop/duplicate/corrupt, slow-drain peer), seeded as the
  reference's.
- **Device** (:mod:`p2pnetwork_tpu_torch.chaos.device`): seeded halo-hop
  faults for the ring (:class:`FaultSchedule` / :class:`FaultSpec` as a
  ``comm=`` value) and one-shot chunk-dispatch faults
  (:class:`DispatchChaos`: chip preemption, wedged dispatch) for the
  engine and serving loops. Recovery lives in
  :mod:`p2pnetwork_tpu_torch.supervise.heal`.
- **Churn** (:mod:`p2pnetwork_tpu_torch.chaos.storm`): seeded
  join/leave/grow overlay storms (:class:`ChurnPattern` /
  :class:`ChurnSchedule`) driven through the service's live mutation
  plane, interleavable with a traffic schedule.
- **Crash storms** (:mod:`p2pnetwork_tpu_torch.chaos.crashstorm`):
  seeded SIGKILL schedules (:class:`CrashSchedule` / :class:`KillPoint`)
  against the serving trail's durability seams, driven as a subprocess
  soak that asserts zero acknowledged-ticket loss.

``storm`` and ``crashstorm`` load on first attribute access, as in the
reference.
"""

from p2pnetwork_tpu_torch.chaos.device import (ChipLost, DispatchChaos,
                                                FaultSchedule, FaultSpec,
                                                FaultyComm,
                                                UnreachableFaultSite,
                                                WedgedDispatch,
                                                install_dispatch_chaos)
from p2pnetwork_tpu_torch.chaos.plane import ChaosPlane
from p2pnetwork_tpu_torch.chaos.streams import ChaosReader, ChaosWriter

__all__ = [
    "ChaosPlane", "ChaosReader", "ChaosWriter",
    "FaultSchedule", "FaultSpec", "FaultyComm", "DispatchChaos",
    "ChipLost", "WedgedDispatch", "UnreachableFaultSite",
    "install_dispatch_chaos",
    "ChurnPattern", "ChurnSchedule",
    "CrashSchedule", "KillPoint", "CampaignError", "KILL_KINDS",
]

_STORM_NAMES = ("ChurnPattern", "ChurnSchedule")

_CRASHSTORM_NAMES = ("CrashSchedule", "KillPoint", "CampaignError",
                     "KILL_KINDS")


def __getattr__(name):
    if name in _STORM_NAMES:
        from p2pnetwork_tpu_torch.chaos import storm
        return getattr(storm, name)
    if name in _CRASHSTORM_NAMES:
        from p2pnetwork_tpu_torch.chaos import crashstorm
        return getattr(crashstorm, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
