"""The ring's interconnect byte model (torch counterpart of the byte model
in ``p2pnetwork_tpu/parallel/commviz.py``).

The reference prices the collectives of a traced ring program
(``jaxpr_comm_census``): every ``ppermute``, ``psum``/``pmax``/``pmin``
and ``all_gather`` of the loop, with ``while_loop`` bodies counted once
(so a run-to-* loop's total is per round) and the hops of a ring pass
counted ``S - 1`` times, priced by :func:`ring_model_bytes`. The port has
no traced program, so :func:`ring_census` lists the same collectives by
hand for each loop the ring's flight recorder records, and
:func:`ici_round_bytes` sums them: the ``ici_bytes`` column of
``parallel/sharded.py``'s recorded loops. On one card nothing crosses an
interconnect; the number is what the reference's multi-chip program of
the same shapes would move a round.

The ``pallas`` comm's hops (the ring-DMA kernels) are priced as
``ppermute``'s: one payload copy a hop, listed under ``"ring_dma"``.

:func:`ring_hop_census` is the port's form of the reference's
``ring_hop_classes(lower_ring_flood_hlo(), host_of)`` (its
``examples/hierarchical_mesh_demo.py``): where the reference reads the
source -> target pairs of the compiled flood's collective-permutes, the
port runs a flood round on a ring of ranks and records the rank pairs of
every hop it makes, and counts the round's exchanges through the process
group, classified by host.
"""

from __future__ import annotations

import functools

__all__ = ["RING_DMA_KEY", "ring_model_bytes", "ring_census",
           "ici_round_bytes", "ring_hop_census"]

#: The census key of a ring-DMA hop (the ``pallas`` comm).
RING_DMA_KEY = "ring_dma"

#: Bytes of one i32/u32 scalar.
_WORD = 4

def ring_model_bytes(prim: str, nbytes: int, axis_size: int) -> int:
    """The static byte model of one collective on an ``axis_size``-way
    ring: a ``ppermute`` (and a ring-DMA hop) moves its operand once; a
    ``psum``/``pmax``/``pmin`` (ring all-reduce) ``2·(S-1)/S`` copies; an
    ``all_gather`` ``S - 1`` shard-sized pieces."""
    s = max(axis_size, 2)
    if prim in ("ppermute", RING_DMA_KEY):
        return nbytes
    if prim in ("psum", "pmax", "pmin"):
        return int(nbytes * 2 * (s - 1) / s)
    if prim in ("all_gather", "all_to_all", "reduce_scatter"):
        return nbytes * (s - 1)
    return nbytes


def ring_census(loop: str, n_shards: int, block: int, *, n_words: int = 0,
                comm: str = "ppermute") -> dict:
    """``{prim: {"count", "bytes"}}`` of one round of a recorded ring loop,
    the reference's census of the same program:

    - ``"flood"`` (``flood_until_coverage``'s dense loop, every layout):
      the live-count and initial covered-count ``psum`` outside the loop,
      the round's messages and covered-count ``psum``, and ``S - 1`` hops
      of the ``bool[block]`` frontier;
    - ``"batch"`` (``run_batch_until_coverage``'s lane ring, ``n_words``
      lane words): the live-count ``psum`` outside the loop, the round's
      per-word sends (``u32[W]``), per-lane counts (``i32[32 W]``) and
      union occupancy ``psum``, and ``S - 1`` hops of the ``u32[W,
      block]`` word stack.

    ``comm`` names the hop: ``"ppermute"``, or ``"pallas"`` for the
    ring-DMA kernels (``"ring_dma"``, same price)."""
    S = int(n_shards)
    if loop == "flood":
        psums = [_WORD] * 4
        payload = int(block)
    elif loop == "batch":
        w = int(n_words)
        psums = [_WORD, _WORD * w, _WORD * 32 * w, _WORD]
        payload = _WORD * w * int(block)
    else:
        raise ValueError(f"loop must be 'flood' or 'batch', got {loop!r}")
    hop = RING_DMA_KEY if comm == "pallas" else "ppermute"
    out = {"psum": {"count": len(psums),
                    "bytes": sum(ring_model_bytes("psum", b, S)
                                 for b in psums)}}
    if S > 1:
        out[hop] = {"count": S - 1,
                    "bytes": (S - 1) * ring_model_bytes(hop, payload, S)}
    return out


def ici_round_bytes(loop: str, n_shards: int, block: int, *,
                    n_words: int = 0, comm: str = "ppermute") -> int:
    """The per-round byte estimate of a recorded ring loop (the sum of
    :func:`ring_census`), cached per shape config."""
    return _round_bytes(loop, int(n_shards), int(block), int(n_words), comm)


#: The estimate depends on the block, the shard count and the lane words,
#: not on the graph's contents; a bounded cache keeps the recent configs.
@functools.lru_cache(maxsize=256)
def _round_bytes(loop: str, n_shards: int, block: int, n_words: int,
                 comm: str) -> int:
    return sum(rec["bytes"] for rec in ring_census(
        loop, n_shards, block, n_words=n_words, comm=comm).values())


class _HopLog:
    """A ``comm=`` spec for ``parallel/sharded.py`` whose comm runs the
    named backend and logs the rank pairs of every hop it makes: one list
    a hop, a pair for each shard held here, ``(its rank, the rank of the
    shard it moves to)``."""

    def __init__(self, backend: str):
        self.backend = backend
        self.hops = []

    def make(self, axis_name: str, axis_size: int, *, mesh=None):
        from p2pnetwork_tpu_torch.parallel import sharded

        inner = (sharded._RankComm(self.backend, mesh) if mesh is not None
                 else sharded._RingComm(self.backend, axis_size))
        return _LoggedComm(self, inner, mesh, axis_size)


class _LoggedComm:
    """The comm of a :class:`_HopLog`: the inner backend's hops, each
    logged before it runs."""

    def __init__(self, log: _HopLog, inner, mesh, n_shards: int):
        self._log, self._inner = log, inner
        self.backend, self.fuses = inner.backend, inner.fuses
        lo, n_local = (0, n_shards) if mesh is None else (mesh.shard_lo,
                                                          mesh.n_local)
        order = (0,) if mesh is None else mesh.order

        def rank(d):
            return order[(d % n_shards) // n_local]

        shards = range(lo, lo + n_local)
        self._fwd = [(rank(d), rank(d + 1)) for d in shards]
        self._back = [(rank(d), rank(d - 1)) for d in shards]

    def shift(self, x):
        self._log.hops.append(self._fwd)
        return self._inner.shift(x)

    def shift_back(self, x):
        self._log.hops.append(self._back)
        return self._inner.shift_back(x)

    def fused_segment_sum(self, *args, **kwargs):
        out = self._inner.fused_segment_sum(*args, **kwargs)
        if out is not None:
            self._log.hops.append(self._fwd)
        return out


def ring_hop_census(sg, mesh, host_of, *, source: int = 0,
                    comm: str = "auto") -> dict:
    """The hops of one round of the ring's flood on ``mesh`` (a ring of
    ranks, ``parallel/multihost.hierarchical_ring_mesh``, and ``sg`` this
    rank's part of it), by rank pair and host (``host_of``: rank -> host,
    ``multihost.host_of``). Every rank calls it together, and every rank
    gets the whole ring's census:

    - ``per_permute``: the hops grouped into permutes by their pair list,
      one entry a distinct list, each pair ``(source rank, target
      rank)`` for every shard in ring order, as the reference's compiled
      flood lists its collective-permutes (its ring loop's body holds one
      permute, which runs ``S - 1`` times a pass);
    - ``within`` / ``cross``: the pairs of ``per_permute`` whose two ranks
      share a host / do not (the reference's ``ring_hop_classes``);
    - ``hops``, ``hops_within``, ``hops_cross``: the hops the round made
      and their pairs by class (``S - 1`` hops a pass);
    - ``exchanges``, ``exchanges_cross``: the round's exchanges through
      the process group, and those whose group spans more than one host.

    One exchange more gathers the ranks' hop logs; it is not counted."""
    from p2pnetwork_tpu_torch.parallel import mesh as M, sharded

    log = _HopLog(sharded.resolve_comm(comm, sg.device))
    before = M.EXCHANGES
    sharded.flood(sg, mesh, source, 1, comm=log)
    exchanges = M.EXCHANGES - before
    logs = [log.hops]
    if mesh.world > 1:
        import torch.distributed as dist

        logs = [None] * mesh.world
        dist.all_gather_object(logs, log.hops, group=mesh.group)
        logs = [logs[r] for r in mesh.order]
    hops = [[p for part in parts for p in part] for parts in zip(*logs)]
    per_permute = []
    for pairs in hops:
        if pairs not in per_permute:
            per_permute.append(pairs)

    def split(lists):
        cross = sum(host_of(a) != host_of(b) for pairs in lists
                    for a, b in pairs)
        return sum(len(pairs) for pairs in lists) - cross, cross

    within, cross = split(per_permute)
    hops_within, hops_cross = split(hops)
    spans_hosts = len({host_of(r) for r in range(mesh.world)}) > 1
    return {"within": within, "cross": cross, "per_permute": per_permute,
            "hops": len(hops), "hops_within": hops_within,
            "hops_cross": hops_cross, "exchanges": exchanges,
            "exchanges_cross": exchanges if spans_hosts else 0}
