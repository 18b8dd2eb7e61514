"""Protocols of the port: the flood family, SIR, gossip, push-sum and
PageRank, each behind the ``models/base.py`` seam."""

from p2pnetwork_tpu_torch.models.adaptive_flood import (  # noqa: F401
    AdaptiveFlood, AdaptiveFloodBitState, AdaptiveFloodState)
from p2pnetwork_tpu_torch.models.flood import (  # noqa: F401
    Flood, FloodBitState, FloodState)
from p2pnetwork_tpu_torch.models.gossip import Gossip, GossipState  # noqa: F401
from p2pnetwork_tpu_torch.models.pagerank import (  # noqa: F401
    PageRank, PageRankState)
from p2pnetwork_tpu_torch.models.pushsum import PushSum, PushSumState  # noqa: F401
from p2pnetwork_tpu_torch.models.sir import SIR, SIRState  # noqa: F401
