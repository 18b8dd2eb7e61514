"""PyTorch/CUDA port of the ``p2pnetwork_tpu`` simulation backend.

The same graphs, protocols and round engine as the JAX package, as torch
tensors on an NVIDIA Hopper card. The JAX package stays the reference:
every ported piece is held against it in ``tests/test_torch_*.py``.

Layout mirrors the reference so each counterpart is easy to find:

- ``sim/graph.py`` — host-side (numpy) graph builds, moved to the device
  once at the end; ``sim/topology.py``, ``sim/failures.py`` — churn;
- ``ops/`` — aggregation: ``segment.py`` (method dispatch), ``blocked.py``
  and ``diag.py`` (the blocked and diagonal+remainder layouts),
  ``segsum.py`` (the hand-written CUDA segment-sum kernel, source in
  ``csrc/segsum.cu``), ``frontier.py``, ``skew.py``, ``bitset.py``,
  ``ring.py``; ``threefry.py`` (the random-bits kernel,
  ``csrc/threefry.cu``);
- ``prng.py`` — ``jax.random``'s counterpart: host keys, bit-exact draws;
- ``models/`` — ``Flood``, ``AdaptiveFlood``, ``SIR``, ``Gossip``,
  ``PushSum`` and ``PageRank`` behind the ``base.py`` seam;
- ``sim/engine.py`` — ``run`` / ``run_from``, ``run_until_coverage[_from]``
  and ``run_until_converged``, keyed as the reference's;
- ``parallel/`` — the ring plane, all shards stacked on one card;
- ``interop.py`` — builds port objects from a JAX graph/state/key's arrays.

Every entry point takes ``device=None``, which means ``cuda``; without a
card it raises unless the caller passes ``device="cpu"`` (see
``_device.py``). This package imports neither ``jax`` nor anything of
``p2pnetwork_tpu``; importing it builds nothing (kernels compile on their
first CUDA call, ``_build.py``).
"""
