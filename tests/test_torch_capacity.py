"""The memory planner (``p2pnetwork_tpu_torch/analysis/ir/capacity.py``)
and ``SimService``'s ``hbm_budget_bytes`` gate against the JAX package's
(``p2pnetwork_tpu/analysis/ir/capacity.py``, ``serve/service.py``).

Both packages read the same model dict: the port's checked-in
``membudgets.json``, whose coefficients were fitted on the card by
``tools/fit_capacity.py``. The plans are host arithmetic, so they must be
equal, plan for plan; the reference service is handed the port's model
by patching its loader inside the test. The gate's cases mirror
``TestServeMemoryGate`` (``tests/test_memplane.py``).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from p2pnetwork_tpu.analysis.ir import capacity as JC  # noqa: E402
from p2pnetwork_tpu.analysis.ir import memory as JMEM  # noqa: E402
from p2pnetwork_tpu.serve import service as JSVC  # noqa: E402
from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu import telemetry as JT  # noqa: E402
from p2pnetwork_tpu_torch import telemetry as PT  # noqa: E402
from p2pnetwork_tpu_torch.analysis.ir import capacity as TC  # noqa: E402
from p2pnetwork_tpu_torch.serve import service as TSVC  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402

MODEL = TC.load_membudgets().get("capacity_model")
#: A per-card budget named for the plans (the reference's default is a
#: TPU's; the port's, the fitted card's memory).
CARD = 80 * 1024**3


def test_checked_in_model_is_the_cards_own():
    assert MODEL is not None and MODEL["schema"] == TC.CAPACITY_SCHEMA
    card = MODEL["card"]
    assert "H100" in card["name"] and card["power_limit"].endswith("W")
    assert card["nvidia_smi"] == f"{card['name']}, {card['power_limit']}"
    assert card["total_memory"] > 64 * 1024**3
    assert TC.DEFAULT_SERVING_ENTRY in MODEL["entries"]
    assert 0.0 <= MODEL["max_resid"] < TC.MODEL_TOLERANCE
    pts = MODEL["points"]
    assert len(pts) >= 12 and MODEL["max_resid"] == max(
        p["resid"] for p in pts if p["fitted"])
    # Every point is a measurement of the program at >= 64K nodes.
    assert min(p["n_nodes"] for p in pts) >= 65_536
    assert {p["lane_words"] for p in pts} >= {1, 8, 32}
    for e in MODEL["entries"].values():
        assert e["points"] >= 6 and e["max_resid"] <= MODEL["max_resid"]
    for e in MODEL["unfitted"].values():
        assert e["max_resid"] > TC.MODEL_TOLERANCE
    # Both families were measured; every point names its entry's status.
    assert {p["entry"] for p in pts} == set(MODEL["entries"]) | set(
        MODEL["unfitted"]) >= {"cov/batchflood-engine@ws",
                               "cov/batchflood-engine@ba"}
    assert all(p["fitted"] == (p["entry"] in MODEL["entries"]) for p in pts)


@pytest.mark.parametrize("headroom", [0.9, 0.5])
@pytest.mark.parametrize("n_nodes,lanes", [
    (300, 32), (4096, 0), (100_000, 1024), (1_000_000, 10_016),
    (16_777_216, 64), (50_000_000, 320_000)])
def test_plan_equals_reference(n_nodes, lanes, headroom):
    kw = dict(per_chip_hbm_bytes=CARD, headroom=headroom, model=MODEL)
    assert TC.plan(n_nodes, lanes, **kw) == JC.plan(n_nodes, lanes, **kw)


@pytest.mark.parametrize("n_pad,e_pad,words,shards", [
    (65_536, 655_360, 1, 1), (100_096, 1_000_064, 32, 1),
    (1_000_064, 10_000_000, 313, 8), (131_072, 655_360, 0, 3)])
def test_serving_footprint_equals_reference(n_pad, e_pad, words, shards):
    got = TC.serving_footprint_bytes(n_pad, e_pad, words, shards,
                                     model=MODEL)
    assert got == JC.serving_footprint_bytes(n_pad, e_pad, words, shards,
                                             model=MODEL)
    assert got > 0


def test_northstar_plan_equals_reference():
    assert TC.northstar_plan(CARD, model=MODEL) \
        == JC.northstar_plan(CARD, model=MODEL)
    # Its default budget is the fitted card's memory.
    assert TC.northstar_plan(model=MODEL)["per_chip_hbm_bytes"] \
        == MODEL["card"]["total_memory"]


def test_plan_refusals_equal_reference():
    # An entry whose fit missed the tolerance (``unfitted``) is planned by
    # neither package.
    for mod in (TC, JC):
        with pytest.raises(ValueError, match="no capacity model"):
            mod.plan(1000, model={"x": 1})
        for entry in ("nope@ws", *MODEL["unfitted"]):
            with pytest.raises(ValueError, match="no fitted capacity entry"):
                mod.plan(1000, entry=entry, per_chip_hbm_bytes=CARD,
                         model=MODEL)
            assert mod.serving_footprint_bytes(1, 1, 1, entry=entry,
                                               model=MODEL) is None
        assert mod.serving_footprint_bytes(1, 1, 1, model={}) is None


def test_fit_recovers_an_exact_model():
    """Records of an exact closed form fit it back: per-entry c0, cN, cE
    and the shared lane slope; every residual 0."""
    truth = {"ws": (2.5e6, 37.0, 9.0), "ba": (1.0e6, 41.0, 7.5)}
    cw = 12.0
    recs = []
    for fam, (c0, cn, ce) in truth.items():
        for n, epn in ((65_536, 10), (131_072, 10), (262_144, 6),
                       (1_000_064, 10)):
            for w in (1, 8, 32):
                e = n * epn
                recs.append({"entry": f"prog@{fam}", "n_pad": n, "e_pad": e,
                             "lane_words": w,
                             "bytes": c0 + cn * n + ce * e
                             + cw * (w - 1) * n})
    m = TC.fit_capacity_model(recs, card={"name": "card"})
    assert m["lane"]["cW"] == pytest.approx(cw, rel=1e-6)
    for fam, (c0, cn, ce) in truth.items():
        got = m["entries"][f"prog@{fam}"]
        assert got["cN"] == pytest.approx(cn, rel=1e-6)
        assert got["cE"] == pytest.approx(ce, rel=1e-6)
        assert got["c0"] == pytest.approx(c0, rel=1e-6)
        assert got["points"] == 12 and got["max_resid"] < 1e-6
    assert m["max_resid"] < 1e-6 and len(m["points"]) == 24
    assert m["card"] == {"name": "card"} and m["unfitted"] == {}
    json.dumps(m)  # the document is JSON


def test_fit_refuses_an_entry_off_the_shared_lane_slope():
    """The schema has one lane slope, fitted on the serving entry; an
    entry whose lanes cost twice as much misses it and is not planned."""
    recs = []
    for entry, cw in ((TC.DEFAULT_SERVING_ENTRY, 80.0), ("prog@ba", 160.0)):
        for n, epn in ((65_536, 10), (262_144, 10), (262_144, 6),
                       (1_000_064, 10)):
            for w in (1, 8, 32):
                recs.append({"entry": entry, "n_pad": n, "e_pad": n * epn,
                             "lane_words": w,
                             "bytes": 1e6 + 100.0 * n + 20.0 * n * epn
                             + cw * (w - 1) * n})
    m = TC.fit_capacity_model(recs)
    assert list(m["entries"]) == [TC.DEFAULT_SERVING_ENTRY]
    assert m["lane"]["cW"] == pytest.approx(80.0, rel=1e-6)
    assert m["unfitted"]["prog@ba"]["max_resid"] > TC.MODEL_TOLERANCE
    assert m["max_resid"] < 1e-6
    assert {p["fitted"] for p in m["points"]
            if p["entry"] == "prog@ba"} == {False}


def test_resident_bytes_counts_each_storage_once():
    a = torch.zeros(100, dtype=torch.int32)
    b = torch.zeros(10, dtype=torch.bool)
    assert TC.resident_bytes(a, (a[:5], [b]), {"x": a}) == 410


# --------------------------------------------- the service's budget gate


@pytest.fixture(scope="module")
def ws4096():
    """The reference's gate graph (WS, k = 6) at 4,096 nodes in place of
    300: the H100 model's intercept is negative (its fit starts at 64K
    nodes), so 300 nodes would plan below zero bytes."""
    return (JG.watts_strogatz(4096, 6, 0.2, seed=3, source_csr=True),
            TG.watts_strogatz(4096, 6, 0.2, seed=3, source_csr=True,
                              device="cpu"))


@pytest.fixture
def same_model(monkeypatch):
    """Both packages' loaders hand out the port's checked-in model."""
    monkeypatch.setattr(JMEM, "load_membudgets",
                        lambda *a: {"capacity_model": MODEL})
    monkeypatch.setattr(TC, "load_membudgets",
                        lambda *a: {"capacity_model": MODEL})


def _pair(graphs, **kw):
    kw = {"capacity": 32, "queue_depth": 8, "seed": 0, **kw}
    return (JSVC.SimService(graphs[0], registry=JT.Registry(), **kw),
            TSVC.SimService(graphs[1], registry=PT.Registry(), **kw))


def _shed(svc):
    """The ``MemoryBudgetExceeded`` class of ``svc``'s package."""
    return (TSVC if isinstance(svc, TSVC.SimService)
            else JSVC).MemoryBudgetExceeded


def _planned_now(graph):
    return TC.serving_footprint_bytes(graph.n_nodes_padded,
                                      graph.n_edges_padded, 1, model=MODEL)


@pytest.mark.parametrize("budget,match", [
    (1024.0, "over hbm_budget_bytes"), (0.0, "must be > 0"),
    (-5.0, "must be > 0")], ids=["over-budget", "zero", "negative"])
def test_construction_refusals_equal_reference(ws4096, same_model, budget,
                                               match):
    for graph, mod in zip(ws4096, (JSVC, TSVC)):
        with pytest.raises(ValueError, match=match) as ei:
            mod.SimService(graph, capacity=32, queue_depth=8,
                           hbm_budget_bytes=budget)
        if budget > 0:
            assert str(_planned_now(graph)) in str(ei.value)


def test_construction_refuses_the_knob_without_a_model(ws4096, monkeypatch):
    monkeypatch.setattr(JMEM, "load_membudgets", lambda *a: {})
    monkeypatch.setattr(TC, "load_membudgets", lambda *a: {})
    for graph, mod in zip(ws4096, (JSVC, TSVC)):
        with pytest.raises(ValueError, match="no capacity model"):
            mod.SimService(graph, capacity=32, queue_depth=8,
                           hbm_budget_bytes=float(1 << 30))


def test_grow_over_budget_sheds_as_reference(ws4096, same_model):
    # Roomy for the construction plan and a small repad's, far under a
    # 10M-node repad's.
    assert _planned_now(ws4096[1]) > 0
    budget = 16.0 * _planned_now(ws4096[1])
    sheds = []
    for svc in _pair(ws4096, hbm_budget_bytes=budget):
        try:
            before = svc.stats()["rejected"]
            with pytest.raises(_shed(svc)) as ei:
                svc.grow(10_000_000)
            d = ei.value.to_dict()
            assert d["reason"] == "memory_budget"
            assert d["planned_bytes"] > d["hbm_budget_bytes"]
            assert d["planned_capacity"] >= 10_000_000
            assert svc.stats()["rejected"] == before + 1
            assert not svc._mutations
            svc.grow(10)
            assert len(svc._mutations) == 1
            sheds.append(d)
        finally:
            svc.close()
    assert sheds[0] == sheds[1]


def test_submit_over_plan_sheds_as_reference(ws4096, same_model):
    sheds = []
    for svc in _pair(ws4096, hbm_budget_bytes=float(1 << 30)):
        try:
            assert svc.submit(0).startswith("t")
            # The operator tightening the knob on a live service: every
            # admission sheds with the structured payload.
            svc.hbm_budget_bytes = 1.0
            with pytest.raises(_shed(svc)) as ei:
                svc.submit(1)
            sheds.append(ei.value.to_dict())
        finally:
            svc.close()
    assert sheds[0] == sheds[1]
    assert sheds[1]["planned_bytes"] == _planned_now(ws4096[1])
    assert np.isfinite(sheds[1]["planned_capacity"])


def test_queued_growth_counts_against_submits(ws4096, same_model):
    """A grow that fits, queued, raises the plan every later submit is
    priced at (the pending repad), in both packages alike."""
    planned = []
    for svc in _pair(ws4096, hbm_budget_bytes=float(1 << 40)):
        try:
            svc.grow(1000)
            svc.hbm_budget_bytes = float(_planned_now(ws4096[1]))
            with pytest.raises(_shed(svc)) as ei:
                svc.submit(2)
            planned.append(ei.value.to_dict())
        finally:
            svc.close()
    assert planned[0] == planned[1]
    assert planned[1]["planned_capacity"] > ws4096[1].n_nodes_padded
