"""The ring-sharded plane (torch counterpart of ``p2pnetwork_tpu/parallel``):
``mesh.ring_mesh``, ``auto.resolve_comm`` and the ring protocols of
``sharded``, every shard stacked on one card; ``multihost`` splits the
ring over rank processes (``hierarchical_ring_mesh``), each holding its
own shards, its hops CUDA IPC peer writes."""
