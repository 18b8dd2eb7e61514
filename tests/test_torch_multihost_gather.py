"""A ring pass's one exchange across ranks (``ops/ring.py``:
``ring_gather``, ``ring_rows``, ``ring_pass_segsum_*``; the passes of
``parallel/sharded.py`` on a ``_RankComm``) against the hops it replaces
and the JAX ring.

Rank processes (``multihost.launch``, gloo on loopback, the CPU) run
``tests/torch_rank_worker.py::rotations`` at worlds 2 and 4 of an
8-shard ring, on the hierarchical mesh's ring order and on one whose
neighbours are swapped (the ranks no longer in rank order around the
ring). Held bit for bit: the gathered slab to the whole ring's stack in
ring order, twice; each step's rows to the same step from chained
``ring_put`` hops and to ``torch.roll`` of the stack; the pass kernel's
plain version (extents given and not) to the fold from hops and to the
one-process fold over the whole ring; and ``propagate`` of a sum and an
OR on a graph with a dynamic region (failures and runtime links) on the
MXU layouts to the one-process ring and the JAX ring, where the sum keeps
the reference's fold order (static group, dynamic group, pieces, a step
at a time).
"""

import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu.parallel import mesh as JM  # noqa: E402
from p2pnetwork_tpu.parallel import sharded as JS  # noqa: E402
from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu_torch.ops import segsum  # noqa: E402
from p2pnetwork_tpu_torch.parallel import multihost  # noqa: E402
from tests import torch_rank_worker as W  # noqa: E402
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401

S = 8
WORLDS = (2, 4)
ORDERS = ("ring", "swapped")
WORKER = str(Path(W.__file__).resolve())
RANK_TIMEOUT = 240


@functools.lru_cache(maxsize=None)
def _ranks(world: int) -> list:
    return multihost.launch(f"{WORKER}:rotations", world, (S,),
                            timeout=RANK_TIMEOUT, device="cpu")


def _by_position(parts, order: str, key):
    """The ranks' ``key`` rows stacked in ring order (by shard_lo)."""
    recs = sorted((p[order] for p in parts), key=lambda r: r["shard_lo"])
    return np.concatenate([key(r) for r in recs])


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def _same(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert np.array_equal(_bits(got), _bits(want)), what


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("world", WORLDS)
def test_gather_is_the_ring_stack_twice(world, order, one_torch_thread):
    parts = _ranks(world)
    for i, (dtype, shape) in enumerate(W.ROTATION_PAYLOADS):
        whole = W.global_payload(S, dtype, shape).numpy()
        for p in parts:
            _same(p[order]["payloads"][i]["slab"],
                  np.concatenate([whole, whole]), f"{dtype} rank "
                  f"{p['rank']}")
    lo = sorted(p[order]["shard_lo"] for p in parts)
    assert lo == [r * S // world for r in range(world)]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("world", WORLDS)
def test_step_rows_are_the_chained_hops(world, order, one_torch_thread):
    parts = _ranks(world)
    for i, (dtype, shape) in enumerate(W.ROTATION_PAYLOADS):
        whole = W.global_payload(S, dtype, shape)
        for t in range(S):  # t = S - 1 wraps every rank's rows
            rows = _by_position(
                parts, order, lambda r: r["payloads"][i]["rows"][t])
            hops = _by_position(
                parts, order, lambda r: r["payloads"][i]["hops"][t])
            _same(rows, hops, f"{dtype} step {t}")
            _same(rows, torch.roll(whole, t, 0).numpy(), f"{dtype} step {t}")


def _one_process_fold(kind: str) -> np.ndarray:
    """The pass over the whole ring in one process: B1's plain sum of
    each shard's bucket at step t over the block resident there
    (``torch.roll`` of the stack), folded from zeros, t ascending."""
    b = W.pass_buckets(S, 5)
    block = W.PASS_GEOMETRY["block"]
    src, dst, mask = (torch.from_numpy(b[k]) for k in ("src", "dst", "mask"))
    sig = torch.from_numpy(b[kind])
    plain = segsum.segsum_or_plain if kind == "or" \
        else segsum.segsum_sum_plain
    acc = torch.zeros((S, src.shape[2] * block),
                      dtype=torch.bool if kind == "or" else torch.float32)
    for t in range(S):
        step = plain(torch.roll(sig, t, 0), src[:, t], dst[:, t],
                     mask[:, t], block)
        acc = acc | step if kind == "or" else acc + step
    return acc.numpy()


@pytest.mark.parametrize("extent", [False, True])
@pytest.mark.parametrize("kind", ["or", "sum"])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("world", WORLDS)
def test_pass_kernel_plain_equals_the_fold(world, order, kind, extent,
                                           one_torch_thread):
    parts = _ranks(world)
    key = f"pass_{kind}" + ("_extent" if extent else "")
    got = _by_position(parts, order, lambda r: r[key])
    _same(got, _by_position(parts, order, lambda r: r[f"hops_{kind}"]),
          "against the fold from hops")
    _same(got, _one_process_fold(kind), "against one process's fold")


@functools.lru_cache(maxsize=None)
def _dyn_one_process() -> dict:
    from p2pnetwork_tpu_torch.parallel import mesh as TM

    return W.dyn_propagate(TM.ring_mesh(S, device="cpu"))


@functools.lru_cache(maxsize=None)
def _dyn_jax(layout: str) -> dict:
    n, k, p = W.GRAPH
    jg = JG.watts_strogatz(n, k, p, seed=0)
    mesh = JM.ring_mesh(S)
    jsg = JS.shard_graph(jg, mesh, **W.LAYOUTS[layout])
    sgc = JS.with_capacity(JS.fail_nodes(jsg, list(W.FAIL_IDS)), 8)
    sgc = JS.connect(sgc, *W.DYN_LINKS)
    sig = jax.numpy.asarray(W.signal(S * jsg.block).reshape(S, jsg.block))
    return {"sum": np.asarray(JS.propagate(sgc, mesh, sig, "sum",
                                           comm="ppermute")),
            "or": np.asarray(JS.propagate(sgc, mesh, sig > 1.0, "or",
                                          comm="ppermute"))}


@pytest.mark.parametrize("op", ["sum", "or"])
@pytest.mark.parametrize("layout", W.DYN_LAYOUTS)
@pytest.mark.parametrize("world", WORLDS)
def test_rank_pass_with_a_dynamic_region(world, layout, op,
                                         one_torch_thread):
    if len(jax.devices()) < S:
        pytest.skip(f"needs {S} devices (the virtual CPU mesh of conftest)")
    parts = sorted(_ranks(world), key=lambda p: p["ring"]["shard_lo"])
    got = np.concatenate([p[f"dyn-{layout}"][op] for p in parts])
    _same(got, _dyn_one_process()[f"dyn-{layout}"][op], "one process")
    _same(got, _dyn_jax(layout)[op], "the JAX ring")


def test_outgrown_gather_channel_lives_two_gathers(monkeypatch):
    """C10: a gather whose payload outgrows the mesh's gather area makes a
    new one; the old area holds the previous gather's slab view, which
    ``ring_gather`` promises until the gather two after it, so the old
    area is retired and closed only then (it was closed at once, freeing
    a live view). The bookkeeping of ``ring.next_gather``, with a channel
    that records its closes in place of the CUDA IPC area."""
    from types import SimpleNamespace

    from p2pnetwork_tpu_torch.ops import ring

    closed = []

    class Area:
        def __init__(self, mesh, slab_bytes):
            self.slab_bytes, self.seq = slab_bytes, 0

        def close(self):
            closed.append(self)

    monkeypatch.setattr(ring, "GatherChannel", Area)
    mesh = SimpleNamespace(peer={})
    a = ring.next_gather(mesh, 100)       # gather 1: view on a
    assert (a.seq, closed) == (1, [])
    b = ring.next_gather(mesh, 400)       # gather 2 outgrows a
    assert b is not a and b.seq == 1 and closed == []
    assert ring.next_gather(mesh, 400) is b and closed == [a]  # gather 3
    c = ring.next_gather(mesh, 800)       # gather 4 outgrows b
    assert closed == [a]                  # b's gather-3 view lives on
    d = ring.next_gather(mesh, 1600)      # gather 5 outgrows c
    assert closed == [a, b]               # ... until gather 5
    assert ring.next_gather(mesh, 1600) is d   # gather 6
    assert closed == [a, b, c] and d.seq == 2
    assert ring.next_gather(mesh, 16) is d and closed == [a, b, c]
