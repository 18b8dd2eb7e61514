"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on CUDA unless the CPU is asked for by name."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from p2pnetwork_tpu_torch import _device, interop  # noqa: E402
from p2pnetwork_tpu_torch.parallel.mesh import ring_mesh  # noqa: E402
from p2pnetwork_tpu_torch.sim import graph as TG  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "p2pnetwork_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


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
            "mesh.py", "auto.py"} <= names
    assert any(p.parent.name == "parallel" for p in PORT_FILES)


def test_import_leaves_jax_unloaded():
    code = ("import sys, p2pnetwork_tpu_torch.sim.engine, "
            "p2pnetwork_tpu_torch.models.adaptive_flood, "
            "p2pnetwork_tpu_torch.parallel.sharded, "
            "p2pnetwork_tpu_torch.interop; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'p2pnetwork_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("call", [
    lambda: TG.watts_strogatz(64, 4, 0.1),
    lambda: TG.from_edges([0], [1], 2, device="cuda"),
    lambda: interop.graph_from_numpy({}),
    lambda: _device.resolve(None),
    lambda: ring_mesh(8),
], ids=["default-device", "explicit-cuda", "interop", "resolve",
        "ring-mesh"])
def test_entry_points_refuse_cpu_fallback(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is real")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_cpu_runs_when_named():
    g = TG.watts_strogatz(64, 4, 0.1, device="cpu")
    assert g.device.type == "cpu" and g.senders.device.type == "cpu"
