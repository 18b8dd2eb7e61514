"""The port's tracing API (``p2pnetwork_tpu_torch/utils/trace.py``) and
its protocol interface (``models/base.py::Protocol``) against the JAX
package's (``p2pnetwork_tpu/utils/trace.py``, ``models/base.py``).

``run_traced`` on the same seeded graph and key gives the reference's
records key for key and value for value (f32 stats by their float
values), and its summary line but ``wall_s``: ``compile_seconds`` is the
reference's on a compile-cache hit (0.0; the reference runs once first
to warm its cache) and ``device_transfer_bytes`` counts the same stats
history, which ``sim_transfer_bytes_total`` adds as the reference adds
it. ``profile`` writes a Chrome trace on the CPU that names the
annotated region. Every protocol of the port that the engine runs
satisfies ``Protocol`` structurally, with the reference's signatures.
"""

import inspect
import io
import json

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import p2pnetwork_tpu.models as JModels  # noqa: E402
from p2pnetwork_tpu import telemetry as JT  # noqa: E402
from p2pnetwork_tpu.models import base as JBase  # noqa: E402
from p2pnetwork_tpu.models import messagebatch as JMB  # noqa: E402
from p2pnetwork_tpu.models import querybatch as JQB  # noqa: E402
from p2pnetwork_tpu.sim import graph as JG  # noqa: E402
from p2pnetwork_tpu.utils import trace as JTrace  # noqa: E402
import p2pnetwork_tpu_torch.models as TModels  # noqa: E402
from p2pnetwork_tpu_torch import prng, telemetry  # noqa: E402
from p2pnetwork_tpu_torch.models import base as TBase  # noqa: E402
from p2pnetwork_tpu_torch.models import messagebatch as TMB  # noqa: E402
from p2pnetwork_tpu_torch.models import querybatch as TQB  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402
from p2pnetwork_tpu_torch.utils import trace  # noqa: E402
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401

GRAPH = (1024, 10, 0.1)
ROUNDS = 6
KEY = 1
PROTOCOLS = {
    "Flood": dict(source=0, method="segment"),
    "SIR": dict(beta=0.3, gamma=0.1, source=0),
    "HopDistance": dict(source=0),
}


def _graphs():
    return (JG.watts_strogatz(*GRAPH, seed=0),
            TG.watts_strogatz(*GRAPH, seed=0, device="cpu"))


def _lines(buf: io.StringIO) -> list:
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def _jax_traced(jg, name: str):
    """The reference's records and JSON lines, its compile cache warmed
    by a first run."""
    proto = getattr(JModels, name)(**PROTOCOLS[name])
    JTrace.run_traced(jg, proto, jax.random.key(KEY), ROUNDS)
    buf = io.StringIO()
    _, records = JTrace.run_traced(jg, proto, jax.random.key(KEY), ROUNDS,
                                   sink=buf)
    return records, _lines(buf)


@pytest.mark.parametrize("name", list(PROTOCOLS))
def test_run_traced_equals_reference(name, one_torch_thread):
    jg, tg = _graphs()
    want, want_lines = _jax_traced(jg, name)
    buf = io.StringIO()
    proto = getattr(TModels, name)(**PROTOCOLS[name])
    _, got = trace.run_traced(tg, proto, prng.key(KEY), ROUNDS, sink=buf)
    assert got == want
    lines = _lines(buf)
    assert lines[:-1] == want_lines[:-1] == want
    summary, want_summary = lines[-1], want_lines[-1]
    assert summary.pop("wall_s") > 0
    want_summary.pop("wall_s")
    assert summary == want_summary
    assert summary["compile_seconds"] == 0.0
    assert summary["device_transfer_bytes"] == 4 * ROUNDS * len(
        proto.STATS)


def test_transfer_counter_as_reference(one_torch_thread):
    jg, tg = _graphs()
    name = "sim_transfer_bytes_total"
    before = (JT.default_registry().value(name),
              telemetry.default_registry().value(name))
    JTrace.run_traced(jg, JModels.Flood(**PROTOCOLS["Flood"]),
                      jax.random.key(KEY), ROUNDS)
    trace.run_traced(tg, TModels.Flood(**PROTOCOLS["Flood"]),
                     prng.key(KEY), ROUNDS)
    added = (JT.default_registry().value(name) - before[0],
             telemetry.default_registry().value(name) - before[1])
    assert added[0] == added[1] > 0


def test_sink_path_appends_json_lines(tmp_path, one_torch_thread):
    _, tg = _graphs()
    path = tmp_path / "trace.jsonl"
    proto = TModels.Flood(**PROTOCOLS["Flood"])
    for label in ("first", "second"):
        trace.run_traced(tg, proto, prng.key(KEY), ROUNDS, sink=str(path),
                         label=label)
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(lines) == 2 * (ROUNDS + 1)
    assert [line["label"] for line in lines] == \
        ["first"] * (ROUNDS + 1) + ["second"] * (ROUNDS + 1)
    assert [line.get("summary", False) for line in lines[:ROUNDS + 1]] \
        == [False] * ROUNDS + [True]
    assert [line["round"] for line in lines[:ROUNDS]] == list(range(ROUNDS))


def test_profile_writes_a_trace(tmp_path, one_torch_thread):
    with trace.profile(str(tmp_path)):
        with trace.annotate("p2p-region"):
            torch.arange(1000).sum()
    files = list(tmp_path.glob("trace-*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "p2p-region" for e in events)


def test_run_traced_profiles_into_a_directory(tmp_path, one_torch_thread):
    _, tg = _graphs()
    trace.run_traced(tg, TModels.Flood(**PROTOCOLS["Flood"]), prng.key(KEY),
                     ROUNDS, label="flood", profile_dir=str(tmp_path))
    files = list(tmp_path.glob("trace-*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == f"flood:rounds={ROUNDS}" for e in events)


def _engine_protocols():
    """``(name, port class, reference class)`` of every protocol the
    engines run: the models' exports with ``init`` and ``step``, the
    batched planes' protocols."""
    out = []
    for name in sorted(dir(TModels)):
        cls = getattr(TModels, name)
        if (inspect.isclass(cls) and cls is not TBase.Protocol
                and hasattr(cls, "init") and hasattr(cls, "step")):
            out.append((name, cls, getattr(JModels, name)))
    for tmod, jmod, names in (
            (TMB, JMB, ("BatchFlood",)),
            (TQB, JQB, ("MinPlusQueries", "PushSumQueries", "DhtLookups"))):
        out += [(n, getattr(tmod, n), getattr(jmod, n)) for n in names]
    return out


def test_protocol_interface_matches_reference():
    """The structural interface itself: ``init`` and ``step`` with the
    reference's parameters, and, as the reference's, not checkable at
    run time."""
    for method in ("init", "step"):
        assert list(inspect.signature(getattr(TBase.Protocol, method))
                    .parameters) == list(inspect.signature(
                        getattr(JBase.Protocol, method)).parameters)
    assert getattr(TBase.Protocol, "_is_protocol", False)
    assert not getattr(TBase.Protocol, "_is_runtime_protocol", False)
    assert not getattr(JBase.Protocol, "_is_runtime_protocol", False)
    assert TModels.Protocol is TBase.Protocol


@pytest.mark.parametrize("name,cls,ref", _engine_protocols(),
                         ids=[p[0] for p in _engine_protocols()])
def test_protocols_satisfy_the_interface(name, cls, ref):
    """Each protocol has ``init`` and ``step`` taking the reference's
    parameters, and ``step``'s leading ``(graph, state, key)`` as
    ``Protocol`` names them (a batched plane's state is its batch)."""
    for method in ("init", "step"):
        got = list(inspect.signature(getattr(cls, method)).parameters)
        assert got == list(inspect.signature(getattr(ref, method))
                           .parameters), (name, method)
    step = list(inspect.signature(cls.step).parameters)
    assert len(step) >= 4 and step[1] == "graph" and step[-1] == "key"
    assert list(inspect.signature(cls.init).parameters)[1] == "graph"
