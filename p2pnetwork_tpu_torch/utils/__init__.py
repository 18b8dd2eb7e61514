"""Host-side helpers of the port (its own copies of what it needs from the
reference's ``utils/``)."""

from p2pnetwork_tpu_torch.utils.ids import generate_id
from p2pnetwork_tpu_torch.utils.logging import EventLog, EventRecord

__all__ = ["generate_id", "EventLog", "EventRecord"]
