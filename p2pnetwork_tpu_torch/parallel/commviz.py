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
"""

from __future__ import annotations

__all__ = ["RING_DMA_KEY", "ring_model_bytes", "ring_census",
           "ici_round_bytes"]

#: The census key of a ring-DMA hop (the ``pallas`` comm).
RING_DMA_KEY = "ring_dma"

#: Bytes of one i32/u32 scalar.
_WORD = 4

#: Per-round estimates already computed, keyed on the shape config (the
#: estimate depends on the block, the shard count and the lane words, not
#: on the graph's contents): a finite vocabulary per process.
_CACHE: dict = {}


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
    key = (loop, int(n_shards), int(block), int(n_words), comm)
    est = _CACHE.get(key)
    if est is None:
        est = _CACHE[key] = sum(
            rec["bytes"] for rec in ring_census(
                loop, n_shards, block, n_words=n_words, comm=comm).values())
    return est
