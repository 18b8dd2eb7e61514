"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on CUDA unless the CPU is asked for by name."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from p2pnetwork_tpu_torch import _device, interop, prng  # noqa: E402
from p2pnetwork_tpu_torch.models.hopdist import HopDistance  # noqa: E402
from p2pnetwork_tpu_torch.parallel import multihost, sharded  # noqa: E402
from p2pnetwork_tpu_torch.parallel.mesh import ring_mesh  # noqa: E402
from p2pnetwork_tpu_torch.sim import checkpoint  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "p2pnetwork_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "fit_capacity.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or top == "p2pnetwork_tpu"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_the_walk_sees_the_whole_port():
    names = {p.name for p in PORT_FILES}
    assert {"graph.py", "engine.py", "segsum.py", "adaptive_flood.py",
            "interop.py", "chip_smoke.py", "ring.py", "sharded.py",
            "mesh.py", "auto.py", "prng.py", "threefry.py", "sir.py",
            "gossip.py", "pushsum.py", "pagerank.py", "extremum.py",
            "hopdist.py", "leader.py", "components.py", "spanning.py",
            "mis.py", "coloring.py", "kcore.py", "routing.py",
            "messagebatch.py", "querybatch.py", "lanes.py", "accum.py",
            "edgehash.py", "walk.py", "plumtree.py", "bracha.py", "hits.py",
            "centrality.py", "labelprop.py", "bipartite.py", "boruvka.py",
            "triangles.py", "vivaldi.py", "detector.py", "antientropy.py",
            "layout.py", "checkpoint.py", "flightrec.py", "layoutcache.py",
            "registry.py", "concurrency.py", "rowsum.py", "spans.py",
            "history.py", "store.py", "watchdog.py", "runner.py",
            "journal.py", "service.py", "traffic.py", "standby.py",
            "device.py", "storm.py", "crashstorm.py", "heal.py", "slo.py",
            "httpd.py", "export.py", "logging.py", "config.py", "ids.py",
            "wire.py", "nodeconnection.py", "node.py", "plane.py",
            "streams.py", "simnode.py", "commviz.py", "capacity.py",
            "chash.py", "crdt.py", "phi.py", "causal.py", "snapshot.py",
            "sync.py", "termination.py", "securenode.py", "coordnode.py",
            "fit_capacity.py", "multihost.py", "core.py", "torchrules.py",
            "__main__.py", "sched.py", "scenarios.py"} <= names
    assert {"core.py", "concurrency.py", "torchrules.py", "__main__.py"} \
        <= {p.name for p in PORT_FILES if p.parent.name == "analysis"}
    assert {"sched.py", "detector.py", "scenarios.py", "__main__.py",
            "__init__.py"} <= {p.name for p in PORT_FILES
                               if p.parent.name == "race"}
    assert any(p.parent.name == "parallel" for p in PORT_FILES)
    assert any(p.parent.name == "chaos" for p in PORT_FILES)


def test_import_leaves_jax_unloaded():
    code = ("import sys, p2pnetwork_tpu_torch.sim.engine, "
            "p2pnetwork_tpu_torch.models.adaptive_flood, "
            "p2pnetwork_tpu_torch.parallel.sharded, "
            "p2pnetwork_tpu_torch.models, "
            "p2pnetwork_tpu_torch.models.messagebatch, "
            "p2pnetwork_tpu_torch.models.querybatch, "
            "p2pnetwork_tpu_torch.ops.lanes, "
            "p2pnetwork_tpu_torch.utils.accum, "
            "p2pnetwork_tpu_torch.utils.edgehash, "
            "p2pnetwork_tpu_torch.sim.layout, "
            "p2pnetwork_tpu_torch.models.walk, "
            "p2pnetwork_tpu_torch.models.plumtree, "
            "p2pnetwork_tpu_torch.models.triangles, "
            "p2pnetwork_tpu_torch.models.centrality, "
            "p2pnetwork_tpu_torch.sim.checkpoint, "
            "p2pnetwork_tpu_torch.sim.flightrec, "
            "p2pnetwork_tpu_torch.sim.layoutcache, "
            "p2pnetwork_tpu_torch.telemetry, "
            "p2pnetwork_tpu_torch.supervise, "
            "p2pnetwork_tpu_torch.serve, "
            "p2pnetwork_tpu_torch.chaos, "
            "p2pnetwork_tpu_torch.chaos.storm, "
            "p2pnetwork_tpu_torch.chaos.crashstorm, "
            "p2pnetwork_tpu_torch.supervise.heal, "
            "p2pnetwork_tpu_torch.telemetry.slo, "
            "p2pnetwork_tpu_torch.telemetry.httpd, "
            "p2pnetwork_tpu_torch.telemetry.export, "
            "p2pnetwork_tpu_torch.utils.logging, "
            "p2pnetwork_tpu_torch.concurrency, "
            "p2pnetwork_tpu_torch.node, "
            "p2pnetwork_tpu_torch.chaos.plane, "
            "p2pnetwork_tpu_torch.sim.simnode, "
            "p2pnetwork_tpu_torch.parallel.commviz, "
            "p2pnetwork_tpu_torch.analysis.ir.capacity, "
            "p2pnetwork_tpu_torch.analysis, "
            "p2pnetwork_tpu_torch.analysis.__main__, "
            "p2pnetwork_tpu_torch.analysis.torchrules, "
            "p2pnetwork_tpu_torch.analysis.race, "
            "p2pnetwork_tpu_torch.analysis.race.scenarios, "
            "p2pnetwork_tpu_torch.analysis.race.__main__, "
            "p2pnetwork_tpu_torch.utils.chash, "
            "p2pnetwork_tpu_torch.crdt, p2pnetwork_tpu_torch.phi, "
            "p2pnetwork_tpu_torch.causal, p2pnetwork_tpu_torch.snapshot, "
            "p2pnetwork_tpu_torch.sync, p2pnetwork_tpu_torch.termination, "
            "p2pnetwork_tpu_torch.securenode, "
            "p2pnetwork_tpu_torch.coordnode, "
            "p2pnetwork_tpu_torch.interop; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'p2pnetwork_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_crash_campaign_child_imports_no_jax():
    """The crash campaign's child script (a source string the campaign
    writes out) imports torch and the port, never JAX."""
    from p2pnetwork_tpu_torch.chaos import crashstorm

    tree = ast.parse(crashstorm._CHILD.format(repo=str(ROOT)))
    mods = {alias.name for node in ast.walk(tree)
            if isinstance(node, ast.Import) for alias in node.names}
    mods |= {node.module for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom) and node.module}
    assert "torch" in mods
    assert not [m for m in mods if _forbidden(m)], mods
    assert any(m.startswith("p2pnetwork_tpu_torch") for m in mods)


@pytest.mark.parametrize("call", [
    lambda: TG.watts_strogatz(64, 4, 0.1),
    lambda: TG.from_edges([0], [1], 2, device="cuda"),
    lambda: interop.graph_from_numpy({}),
    lambda: _device.resolve(None),
    lambda: ring_mesh(8),
    lambda: prng.uniform(prng.key(0), 4),
    lambda: prng.random_bits(prng.key(0), (2, 3)),
    lambda: interop.protocol_state_from_numpy(
        "SIRState", {"status": np.zeros(4, np.int32)}),
    lambda: prng.permutation(prng.key(0), 8),
    lambda: prng.choice(prng.key(0), 8, (3,)),
    lambda: TG.from_edges([0], [1], 2, weights=[1.0]),
    lambda: interop.protocol_state_from_numpy(
        "KCoreState", {"in_core": np.ones(4, bool)}),
    lambda: TG.chord(16),
    lambda: TG.kademlia(16, 2),
    lambda: interop.message_batch_from_numpy({}),
    lambda: interop.query_batch_from_numpy({}),
    lambda: TG.from_edges([0, 1], [1, 0], 2, reorder="rcm"),
    lambda: prng.choice(prng.key(0), 8, (3,), p=torch.ones(8)),
    lambda: interop.protocol_state_from_numpy(
        "PlumtreeBitState", {"eager": np.zeros(4, np.uint32),
                             "round": np.int32(0)}),
    lambda: interop.protocol_state_from_numpy(
        "AntiEntropyState", {"have": np.zeros((4, 2), bool),
                             "round": np.int32(0)}),
    lambda: checkpoint.load_graph("graph.npz"),
    lambda: sharded.flood_until_coverage(
        sharded.shard_graph(TG.watts_strogatz(64, 4, 0.1), ring_mesh(8),
                            source_csr=True), ring_mesh(8), 0,
        adaptive_k=16),
    lambda: sharded.hopdist_until_coverage(
        sharded.shard_graph(TG.watts_strogatz(64, 4, 0.1), ring_mesh(8),
                            source_csr=True), ring_mesh(8), HopDistance(),
        adaptive_k=16),
    lambda: multihost.hierarchical_ring_mesh(),
    lambda: multihost.rank_device(),
    lambda: multihost.mesh_2d(),
], ids=["default-device", "explicit-cuda", "interop", "resolve",
        "ring-mesh", "prng-uniform", "prng-bits", "interop-state",
        "prng-permutation", "prng-choice", "weighted-build",
        "interop-kcore-state", "chord", "kademlia", "interop-batch",
        "interop-query-batch", "reordered-build", "prng-weighted-choice",
        "interop-plumtree-bits", "interop-antientropy", "load-graph",
        "ring-adaptive-flood", "ring-adaptive-hopdist",
        "hierarchical-ring-mesh", "rank-device", "mesh-2d"])
def test_entry_points_refuse_cpu_fallback(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is real")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_cpu_runs_when_named():
    g = TG.watts_strogatz(64, 4, 0.1, device="cpu")
    assert g.device.type == "cpu" and g.senders.device.type == "cpu"
