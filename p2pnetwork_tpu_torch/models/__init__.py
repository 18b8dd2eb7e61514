"""Protocols of the port: the flood family, SIR, gossip, push-sum,
PageRank, hop distance, leader election, components, spanning tree, MIS,
k-core and distance-vector routing, each behind the ``models/base.py``
seam; ``color_via_mis`` iterates the MIS."""

from p2pnetwork_tpu_torch.models.adaptive_flood import (  # noqa: F401
    AdaptiveFlood, AdaptiveFloodBitState, AdaptiveFloodState,
    AdaptiveHopDistance, AdaptiveHopDistanceState)
from p2pnetwork_tpu_torch.models.coloring import color_via_mis  # noqa: F401
from p2pnetwork_tpu_torch.models.components import (  # noqa: F401
    ConnectedComponents, ConnectedComponentsState)
from p2pnetwork_tpu_torch.models.flood import (  # noqa: F401
    Flood, FloodBitState, FloodState)
from p2pnetwork_tpu_torch.models.gossip import Gossip, GossipState  # noqa: F401
from p2pnetwork_tpu_torch.models.hopdist import (  # noqa: F401
    HopDistance, HopDistanceState, bfs_distances, diameter_bounds,
    eccentricities)
from p2pnetwork_tpu_torch.models.kcore import KCore, KCoreState  # noqa: F401
from p2pnetwork_tpu_torch.models.leader import (  # noqa: F401
    LeaderElection, LeaderElectionState, max_flood_step)
from p2pnetwork_tpu_torch.models.mis import LubyMIS, LubyMISState  # noqa: F401
from p2pnetwork_tpu_torch.models.pagerank import (  # noqa: F401
    PageRank, PageRankState)
from p2pnetwork_tpu_torch.models.pushsum import PushSum, PushSumState  # noqa: F401
from p2pnetwork_tpu_torch.models.routing import (  # noqa: F401
    DistanceVector, DistanceVectorState)
from p2pnetwork_tpu_torch.models.sir import SIR, SIRState  # noqa: F401
from p2pnetwork_tpu_torch.models.spanning import (  # noqa: F401
    SpanningTree, SpanningTreeState)
