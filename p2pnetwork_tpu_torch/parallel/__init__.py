"""The ring-sharded plane (torch counterpart of ``p2pnetwork_tpu/parallel``):
``mesh.ring_mesh``, ``auto.resolve_comm`` and the dense flood of
``sharded``. All shards live on one card, stacked on axis 0."""
