"""The port's flood main path against the JAX package, end to end.

For each protocol of the main path's contest (and the plain ``segment``
flood), ``run_until_coverage`` returns the very same dict — rounds,
coverage (f32 bits), exact messages, occupancy mean — and the very same
final state, work-item lists included, on WS-4096 (built as the benchmark
builds its graph), ER and BA. Batching rounds (``steps_per_round=3``)
changes nothing, and a resumed run from a state carried across equals the
reference's resumed run."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from p2pnetwork_tpu.models import adaptive_flood as JA  # noqa: E402
from p2pnetwork_tpu.models import flood as JF  # noqa: E402
from p2pnetwork_tpu.sim import engine as JE  # noqa: E402
from p2pnetwork_tpu_torch import _device, interop, prng  # noqa: E402
from p2pnetwork_tpu_torch.models import adaptive_flood as TA  # noqa: E402
from p2pnetwork_tpu_torch.models import flood as TF  # noqa: E402
from p2pnetwork_tpu_torch.ops import segsum  # noqa: E402
from p2pnetwork_tpu_torch.parallel import auto as TAUTO  # noqa: E402
from p2pnetwork_tpu_torch.parallel import mesh as TM  # noqa: E402
from p2pnetwork_tpu_torch.parallel import multihost as TMH  # noqa: E402
from p2pnetwork_tpu_torch.sim import engine as TE  # noqa: E402
from p2pnetwork_tpu_torch.sim import topology  # noqa: E402
from tests.test_torch_graph import (FAMILIES, LAYOUTS, build_jax,  # noqa: E402
                                    build_port, graph_fields, state_fields)

#: (name, kwargs) of each protocol; "flood" and "adaptive" name the class.
PROTOCOLS = {
    "flood-pallas": ("flood", {"method": "pallas"}),
    "flood-hybrid": ("flood", {"method": "hybrid"}),
    "flood-segment": ("flood", {"method": "segment"}),
    "adaptive-1024": ("adaptive", {"method": "hybrid", "k": 1024}),
    "adaptive-64": ("adaptive", {"method": "hybrid", "k": 64}),
    # W = 4 chunks rows into several items: the general cumsum/searchsorted
    # expansion instead of the one-item-per-node fast path.
    "adaptive-64-w4": ("adaptive", {"method": "hybrid", "k": 64,
                                    "slice_width": 4}),
}
TARGET = 0.99
MAX_ROUNDS = 64


def protocols(name):
    kind, kw = PROTOCOLS[name]
    if kind == "flood":
        return JF.Flood(source=0, **kw), TF.Flood(source=0, **kw)
    return JA.AdaptiveFlood(source=0, **kw), TA.AdaptiveFlood(source=0, **kw)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def graphs(request):
    return build_jax(request.param, **LAYOUTS), build_port(request.param,
                                                          **LAYOUTS)


def run_jax(jg, proto, **kw):
    return JE.run_until_coverage(jg, proto, jax.random.key(0),
                                 coverage_target=TARGET,
                                 max_rounds=MAX_ROUNDS, **kw)


def run_port(tg, proto, **kw):
    return TE.run_until_coverage(tg, proto, prng.key(0),
                                 coverage_target=TARGET,
                                 max_rounds=MAX_ROUNDS, **kw)


def assert_same_state(got, want):
    got, want = state_fields(got), state_fields(want)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("name", sorted(PROTOCOLS))
def test_run_until_coverage_equals_reference(graphs, name):
    jg, tg = graphs
    jproto, tproto = protocols(name)
    jstate, want = run_jax(jg, jproto)
    tstate, got = run_port(tg, tproto)
    assert got == want
    assert_same_state(tstate, jstate)


def test_ws_4096_numbers():
    # The figures the reference gives on the main path's graph at 4,096
    # nodes; every method agrees on them.
    tg = build_port("ws", **LAYOUTS)
    _, out = run_port(tg, TA.AdaptiveFlood(source=0, method="hybrid", k=1024))
    assert out == {"rounds": 7, "coverage": 1.0, "messages": 39940,
                   "frontier_occupancy_mean": 0.142822265625}


@pytest.mark.parametrize("name", ["flood-hybrid", "adaptive-64",
                                  "adaptive-64-w4"])
def test_steps_per_round_is_bit_identical(name):
    tg = build_port("ws", **LAYOUTS)
    _, tproto = protocols(name)
    s1, out1 = run_port(tg, tproto)
    s3, out3 = run_port(tg, tproto, steps_per_round=3)
    assert out3 == out1
    assert_same_state(s3, s1)


@pytest.mark.parametrize("name", ["flood-pallas", "adaptive-64-w4"])
def test_resume_from_carried_state_equals_reference(graphs, name):
    jg, tg = graphs
    jproto, tproto = protocols(name)
    jmid, _ = JE.run_until_coverage(jg, jproto, jax.random.key(0),
                                    coverage_target=TARGET, max_rounds=2)
    tmid = interop.flood_state_from_numpy(state_fields(jmid), device="cpu")
    jstate, want = JE.run_until_coverage_from(
        jg, jproto, jmid, jax.random.key(0), coverage_target=TARGET,
        max_rounds=MAX_ROUNDS, donate=False)
    tstate, got = TE.run_until_coverage_from(
        tg, tproto, tmid, prng.key(0), coverage_target=TARGET,
        max_rounds=MAX_ROUNDS)
    assert got == want
    assert_same_state(tstate, jstate)


def test_resume_of_a_finished_run_runs_no_round():
    tg = build_port("ws", **LAYOUTS)
    proto = TF.Flood(source=0, method="hybrid")
    state, _ = run_port(tg, proto)
    again, out = TE.run_until_coverage_from(tg, proto, state, prng.key(0),
                                            coverage_target=TARGET)
    assert out["rounds"] == 0 and out["messages"] == 0
    assert_same_state(again, state)


def test_kernel_path_counts_only_on_card():
    # On the CPU the wrappers run their plain versions: no launch counted.
    tg = build_port("ws", **LAYOUTS)
    before = segsum.LAUNCHES
    run_port(tg, TF.Flood(source=0, method="pallas"))
    assert segsum.LAUNCHES == before


def test_adaptive_sync_count():
    tg = build_port("ws", **LAYOUTS)
    before = _device.SYNCS
    _, out = run_port(tg, TA.AdaptiveFlood(source=0, method="hybrid", k=64))
    # One branch read per round plus one exit-flag read per round, the
    # final one and the summary's one transfer.
    assert _device.SYNCS - before == 2 * out["rounds"] + 2


#: Rank 0's place on a ring of 8 shards over 2 ranks, with no group.
RANK0 = TM.RingMesh(n_shards=8, axis_name=TM.DEFAULT_AXIS,
                    device=torch.device("cpu"), rank=0, world=2,
                    order=(0, 1))


def _carry_with(field):
    """Carry the ER graph across with ``field``, which the port's Graph
    does not model, set."""
    def call(tg):
        fields = graph_fields(build_jax("er"))
        fields[field] = np.ones(tg.n_edges_padded, np.float32)
        interop.graph_from_numpy(fields, device="cpu")
    return call


# What is still not ported raises, never runs as something else: a
# protocol that does not say it runs on a rank's part (a user's own, here
# a flood with the mark taken off) on the auto-sharded path across ranks,
# whose placement of a graph with a dynamic edge region and on the 2-D
# mesh runs since it was ported (test_torch_auto_library.py; rank 0's
# part of a 2-rank ring, refused before any exchange), graph and batch
# fields the port does not model (interop
# refuses them rather than dropping them; edge weights and the node
# relabeling are carried since they were ported, in
# test_torch_semiring.py and test_torch_layout.py) and a weighted choice
# without replacement. The ring's flight recorder and its
# frontier-adaptive loop, once held here, are ported and checked in
# test_torch_ring_recorder.py and test_torch_ring_adaptive.py, and across
# ranks in test_torch_multihost_adaptive.py. The flood options this test
# once held (methods frontier and skew, bitset=True) are ported and
# checked in test_torch_frontier.py and test_torch_skew.py, and the orbax
# checkpoints (the port's own sharded format, save_orbax/load_orbax) in
# test_torch_checkpoint.py and test_torch_multihost_protocols.py.
class _UserFlood(TF.Flood):
    RUNS_ON_PART = False


def _user_run(part):
    return TE.run(part, _UserFlood(source=0), prng.key(0), 1)


@pytest.mark.parametrize("proto", [
    lambda tg: _user_run(TAUTO.shard_graph_auto(
        topology.with_capacity(tg, 8), RANK0)),
    lambda tg: _user_run(TAUTO.shard_graph_auto(tg, TMH.Mesh2D(
        grid=np.arange(8).reshape(2, 4), axis_names=("dcn", "ici"),
        ring=RANK0), axis_name="ici")),
    _carry_with("delta_log"),
    lambda tg: prng.choice(prng.key(0), 4, (2,), replace=False,
                           p=torch.ones(4), device="cpu"),
    lambda tg: interop.message_batch_from_numpy(
        {"unmodelled": np.ones(2)}, device="cpu"),
])
def test_unported_options_raise(proto):
    tg = build_port("er")
    with pytest.raises(NotImplementedError):
        proto(tg)


def test_bad_source_and_missing_csr_raise():
    tg = build_port("er")
    with pytest.raises(ValueError):
        TF.Flood(source=tg.n_nodes_padded).init(tg, prng.key(0))
    with pytest.raises(ValueError, match="source-CSR"):
        TA.AdaptiveFlood().init(tg, prng.key(0))
