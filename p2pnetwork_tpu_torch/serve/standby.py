"""Hot-standby failover over a service trail (the port's copy of
``p2pnetwork_tpu/serve/standby.py``).

A :class:`Standby` holds the graph and the service construction kwargs
and constructs nothing until promotion. :meth:`Standby.refresh` reads the
sidecar and scans the journal (file reads only) to report replication
lag. :meth:`Standby.promote` constructs a
:class:`~p2pnetwork_tpu_torch.serve.service.SimService` over the shared
trail with ``resume=True`` and ``epoch = observed + 1``, then forces a
checkpoint, publishing the new fencing token: a zombie primary's next
publish then raises
:class:`~p2pnetwork_tpu_torch.serve.service.FencedEpoch` before its
store entry lands.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from p2pnetwork_tpu_torch.serve.journal import read_records
from p2pnetwork_tpu_torch.serve.service import _SIDECAR, SimService

__all__ = ["Standby"]


class Standby:
    """A warm standby for one service trail (see module doc).

    Parameters
    ----------
    graph:
        The overlay the primary serves — promotion constructs the
        replacement service over it (the resume path's graph-identity
        gate checks it against the trail's recorded fingerprint).
    directory:
        The shared trail directory (the primary's ``store=``): sidecar,
        checkpoint entries and journal segments all live here.
    **service_kwargs:
        Forwarded verbatim to :class:`SimService` at promotion —
        capacity, quotas, checkpoint cadence, journal fsync policy —
        so the promoted service runs the primary's configuration.
        ``store``/``resume``/``epoch`` are owned by the standby and
        must not be passed.
    """

    def __init__(self, graph, directory: str, **service_kwargs: Any):
        for owned in ("store", "resume", "epoch"):
            if owned in service_kwargs:
                raise ValueError(
                    f"Standby owns the {owned!r} kwarg (it resumes the "
                    "shared trail with an incremented fencing epoch); "
                    "pass only service configuration")
        self.graph = graph
        self.directory = os.path.abspath(directory)
        self.service_kwargs: Dict[str, Any] = dict(service_kwargs)
        self._last: Optional[dict] = None

    # ------------------------------------------------------------ tailing

    def refresh(self) -> dict:
        """One cheap replication-lag observation of the shared trail.

        Pure reads (sidecar JSON + journal segment scan); safe to call
        at any cadence while the primary is alive. Returns::

            {"epoch", "tick", "journal_seqno", "checkpoint_file",
             "tickets", "journal_last_seq", "replay_pending",
             "corrupt_tail"}

        where ``replay_pending`` is how many acknowledged intents a
        promotion right now would replay past the pair (the standby's
        "how far behind is the sidecar" number), and missing-sidecar
        fields are 0/None (an empty trail promotes to a fresh service
        at epoch 1).
        """
        side: Dict[str, Any] = {}
        try:
            with open(os.path.join(self.directory, _SIDECAR),
                      "r", encoding="utf-8") as f:
                loaded = json.load(f)
            if isinstance(loaded, dict):
                side = loaded
        except (OSError, ValueError):
            pass
        records, corrupt = read_records(self.directory)
        covered = int(side.get("journal_seqno", 0) or 0)
        obs = {
            "epoch": int(side.get("epoch", 0) or 0),
            "tick": int(side.get("tick", 0) or 0),
            "journal_seqno": covered,
            "checkpoint_file": side.get("checkpoint_file"),
            "tickets": len(side.get("tickets", {}) or {}),
            "journal_last_seq": (int(records[-1]["seq"])
                                 if records else 0),
            "replay_pending": sum(1 for r in records
                                  if int(r["seq"]) > covered),
            "corrupt_tail": int(corrupt),
        }
        self._last = obs
        return obs

    @property
    def last_observation(self) -> Optional[dict]:
        """The most recent :meth:`refresh` result (``None`` before the
        first), for operators logging lag between polls."""
        return None if self._last is None else dict(self._last)

    # ---------------------------------------------------------- promotion

    def promote(self) -> SimService:
        """Become the service: resume the trail at ``observed epoch +
        1`` and publish the fencing token immediately.

        Returns the promoted (not yet started) service. After this
        returns, the zombie primary's next checkpoint attempt raises
        :class:`~p2pnetwork_tpu_torch.serve.service.FencedEpoch` — the token
        is already in the sidecar, published through the same atomic
        rename discipline as every boundary pair.
        """
        obs = self.refresh()
        svc = SimService(self.graph, store=self.directory, resume=True,
                         epoch=int(obs["epoch"]) + 1,
                         **self.service_kwargs)
        try:
            # The promoted pair both claims the trail (token) and
            # compacts the replayed suffix it covers.
            svc.checkpoint()
        except BaseException:
            svc.close()
            raise
        return svc
