"""Protocols of the port: the flood family, SIR, gossip, push-sum,
PageRank, hop distance, leader election, components, spanning tree, MIS,
k-core, distance-vector routing, random walks, Plumtree, Bracha, HITS,
label propagation, bipartiteness, Borůvka, Vivaldi, the failure detector
and anti-entropy, each behind the ``models/base.py`` seam (``Protocol``);
``color_via_mis`` iterates the MIS; ``centrality`` and ``triangles`` hold
the sampled centralities and the triangle counts."""

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
from p2pnetwork_tpu_torch.models.antientropy import (  # noqa: F401
    AntiEntropy, AntiEntropyState)
from p2pnetwork_tpu_torch.models.base import Protocol  # noqa: F401
from p2pnetwork_tpu_torch.models.bipartite import (  # noqa: F401
    BipartiteCheck, BipartiteCheckState)
from p2pnetwork_tpu_torch.models.boruvka import Boruvka, BoruvkaState  # noqa: F401
from p2pnetwork_tpu_torch.models.bracha import Bracha, BrachaState  # noqa: F401
from p2pnetwork_tpu_torch.models.centrality import (  # noqa: F401
    betweenness_sample, closeness_sample)
from p2pnetwork_tpu_torch.models.detector import (  # noqa: F401
    FailureDetector, FailureDetectorState)
from p2pnetwork_tpu_torch.models.hits import HITS, HITSState  # noqa: F401
from p2pnetwork_tpu_torch.models.labelprop import (  # noqa: F401
    LabelPropagation, LabelPropagationState)
from p2pnetwork_tpu_torch.models.plumtree import (  # noqa: F401
    Plumtree, PlumtreeBitState, PlumtreeState)
from p2pnetwork_tpu_torch.models.triangles import (  # noqa: F401
    count_triangles, local_clustering, transitivity, transitivity_sample,
    triangles_per_node)
from p2pnetwork_tpu_torch.models.vivaldi import Vivaldi, VivaldiState  # noqa: F401
from p2pnetwork_tpu_torch.models.walk import (  # noqa: F401
    RandomWalks, RandomWalksState)
