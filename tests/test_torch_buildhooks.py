"""The kernel-build counters (``telemetry/buildhooks.py``), the build's
reports to them (``_build.py``), ``analysis/retrace_guard.py`` over them,
and ``utils/trace.run_traced``'s ``compile_seconds``: the port's roles of
the reference's ``telemetry/jaxhooks.py`` and ``retrace_guard``. The build
runs a fake ``nvcc`` here (no CUDA toolkit on the CPU)."""

import io
import json
import sys
import warnings

import pytest

torch = pytest.importorskip("torch")

from p2pnetwork_tpu_torch import _build, prng  # noqa: E402
from p2pnetwork_tpu_torch.analysis.retrace_guard import (  # noqa: E402
    RetraceBudgetExceeded, retrace_guard)
from p2pnetwork_tpu_torch.telemetry import buildhooks  # noqa: E402
from p2pnetwork_tpu_torch.telemetry.registry import Registry  # noqa: E402

pytestmark = pytest.mark.analysis

_FAKE_NVCC = """\
#!{python}
import shutil, sys, _ctypes
out = sys.argv[sys.argv.index("-o") + 1]
if "-shared" in sys.argv:
    shutil.copy(_ctypes.__file__, out)
else:
    open(out, "wb").close()
"""


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """``_build`` pointed at a one-source tree and a fake ``nvcc``."""
    cuda = tmp_path / "cuda" / "bin"
    cuda.mkdir(parents=True)
    nvcc = cuda / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// kernel\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "OUT_DIR", tmp_path / "out")
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_building", None)
    return monkeypatch


@pytest.fixture
def reg():
    r = Registry()
    buildhooks.install(r)
    yield r
    buildhooks.uninstall(r)


def _reload(monkeypatch):
    """Forget the loaded library, so the next call loads (or builds)."""
    monkeypatch.setattr(_build, "_lib", None)


def test_install_is_idempotent_and_uninstall_stops_counting():
    r = Registry()
    assert buildhooks.install(r) and buildhooks.install(r)
    assert buildhooks.installed(r)
    buildhooks.report("nvcc", 1.5, built=True)
    buildhooks.uninstall(r)
    assert not buildhooks.installed(r)
    buildhooks.report("nvcc", 2.0, built=True)
    assert buildhooks.compile_count(r) == 1
    assert buildhooks.compile_seconds(r) == 1.5
    with pytest.raises(ValueError):
        buildhooks.report("link", 1.0)


def test_a_build_counts_once_and_a_load_counts_none(fake_build, reg):
    _build.library()
    assert buildhooks.compile_count(reg) == 1
    assert buildhooks.compile_seconds(reg, "nvcc") > 0
    assert reg.value("kernel_build_seconds_total", stage="load") >= 0
    # A later process finds the library on disk: it loads, builds nothing.
    _reload(fake_build)
    _build.library()
    assert buildhooks.compile_count(reg) == 1
    assert _build.LAST_BUILD["compiled"] is False


def test_none_subscribes_the_process_default(fake_build):
    from p2pnetwork_tpu_torch import telemetry

    prev = telemetry.set_default_registry(Registry())
    buildhooks.install(None)
    try:
        _build.library()
        assert buildhooks.compile_count() == 1
    finally:
        buildhooks.uninstall(None)
        telemetry.set_default_registry(prev)


def test_guard_raises_on_a_build(fake_build, reg):
    with pytest.raises(RetraceBudgetExceeded) as exc:
        with retrace_guard("cold", budget=0, registry=reg):
            _build.library()
    assert exc.value.compiles == 1 and exc.value.budget == 0
    assert reg.value("retrace_guard_breaches_total", block="cold") == 1
    assert reg.value("retrace_guard_compiles_total", block="cold") == 1


def test_warm_block_stays_within_zero_budget(fake_build, reg):
    _build.library()
    with retrace_guard("warm", budget=0, registry=reg) as g:
        for _ in range(3):
            _build.library()
    assert g.compiles == 0 and not g.breached


@pytest.mark.parametrize("how", ["warn", "callable"])
def test_breach_can_warn_or_call_back(fake_build, reg, how):
    seen = []
    on_breach = "warn" if how == "warn" else seen.append
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with retrace_guard("soft", budget=0, registry=reg,
                           on_breach=on_breach) as g:
            _build.library()
    assert g.breached and g.compiles == 1
    if how == "warn":
        assert any("retrace_guard[soft]" in str(w.message) for w in caught)
    else:
        assert seen == [g]


def test_the_blocks_own_failure_outranks_the_breach(fake_build, reg):
    with pytest.raises(KeyError):
        with retrace_guard("err", budget=0, registry=reg):
            _build.library()
            raise KeyError("the real failure")


def test_bad_arguments_and_reentry():
    with pytest.raises(ValueError):
        retrace_guard("x", budget=-1)
    with pytest.raises(ValueError):
        retrace_guard("x", budget=0, on_breach="explode")
    g = retrace_guard("x", budget=0, registry=Registry())
    with g:
        with pytest.raises(RuntimeError):
            g.__enter__()


def test_run_traced_reports_the_build_seconds(monkeypatch):
    from p2pnetwork_tpu_torch.models.flood import Flood
    from p2pnetwork_tpu_torch.sim import engine
    from p2pnetwork_tpu_torch.sim import graph as G
    from p2pnetwork_tpu_torch.utils import trace

    g = G.watts_strogatz(256, 4, 0.1, seed=0, device="cpu")
    real = engine.run

    def building_run(*a, **k):
        buildhooks.report("nvcc", 0.25, built=True)
        buildhooks.report("load", 0.5)
        return real(*a, **k)

    monkeypatch.setattr(engine, "run", building_run)
    sink = io.StringIO()
    trace.run_traced(g, Flood(source=0), prng.key(0), 3, sink=sink)
    summary = json.loads(sink.getvalue().splitlines()[-1])
    assert summary["compile_seconds"] == pytest.approx(0.75)
    monkeypatch.setattr(engine, "run", real)
    sink = io.StringIO()
    trace.run_traced(g, Flood(source=0), prng.key(0), 3, sink=sink)
    assert json.loads(sink.getvalue().splitlines()[-1])[
        "compile_seconds"] == 0.0
