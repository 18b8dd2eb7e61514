"""The port's tree under its own graftlint: clean with the empty
checked-in baseline, every inline suppression silencing a finding (the
triage pinned), the JAX package's linter agreeing, and the kernel build's
lock repaired (one builder outside the lock, every ``nvcc`` wait bounded,
a failed build raising for every caller)."""

import functools
import json
import os
import re
import sys
import threading
import tokenize
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from p2pnetwork_tpu.analysis import core as ref_core  # noqa: E402
from p2pnetwork_tpu_torch import _build  # noqa: E402
from p2pnetwork_tpu_torch.analysis import core  # noqa: E402
from p2pnetwork_tpu_torch.analysis.__main__ import (  # noqa: E402
    main as graftlint_main,
)
from p2pnetwork_tpu_torch.analysis.race.__main__ import (  # noqa: E402
    default_baseline_path as race_baseline_path,
)
from tests.test_torch_graftlint import (  # noqa: E402
    PORT_ONLY, PORTED, ref_rules, rows)
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401

pytestmark = [pytest.mark.analysis, pytest.mark.usefixtures("one_torch_thread")]

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "p2pnetwork_tpu_torch"
PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")
                    if p.relative_to(PORT).parts[0] != "_build")

#: Findings that inline suppressions silence in the port: the reference's
#: rationales carried onto the code the port copied (the seam, the
#: serving front end, telemetry's server, the store, the engine's
#: occupancy histogram, crdt's merge, the analysers' own internals), the
#: port's own (the row sum's arrival counters, graftaudit's graph cache
#: and rule registry), and the host reads in loops that are counted exit
#: reads or read host numpy (``host-sync-in-loop``, seven findings).
SUPPRESSED = 69

_MARKER = re.compile(r"#\s*graftlint:\s*ignore")


@functools.lru_cache(maxsize=None)
def _audit():
    """The port tree's findings with suppressions off, and its modules
    (one pass of the linter, shared by the tests)."""
    modules = {}
    findings = core.analyze_paths([str(PORT)], root=str(ROOT),
                                  respect_suppressions=False,
                                  collect_sources=modules)
    return findings, modules


def _gated():
    findings, modules = _audit()
    return [f for f in findings if not modules[f.file].suppressed(f)]


@functools.lru_cache(maxsize=None)
def _ref_audit():
    return ref_core.analyze_paths([str(PORT)], rules=ref_rules(),
                                  root=str(ROOT), respect_suppressions=False)


def _markers():
    """(file, line) of every ``# graftlint: ignore`` comment of the port
    (comments only: docstrings that show the syntax do not count)."""
    out = []
    for p in sorted(PORT.rglob("*.py")):
        with open(p, "rb") as f:
            for tok in tokenize.tokenize(f.readline):
                if tok.type == tokenize.COMMENT and _MARKER.search(tok.string):
                    out.append((str(p.relative_to(ROOT)), tok.start[0]))
    return out


def test_port_tree_is_clean_with_the_empty_baseline():
    _, modules = _audit()
    assert core.load_baseline() == {}
    new, old = core.apply_baseline(_gated(), modules, core.load_baseline())
    assert new == [] and old == [], "\n".join(f.render() for f in new)


@pytest.mark.parametrize("path", [core.default_baseline_path(),
                                  race_baseline_path()],
                         ids=["graftlint", "graftrace"])
def test_checked_in_baselines_are_empty(path):
    with open(path, encoding="utf-8") as f:
        assert json.load(f)["findings"] == []


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_has_no_unsuppressed_finding(rel):
    findings = core.analyze_paths([str(ROOT / rel)], root=str(ROOT))
    assert findings == [], "\n".join(f.render() for f in findings)


def test_suppressions_pin_the_triage():
    # Audit view: every finding of the tree is a suppressed one, each
    # inline suppression silences the findings at its own line (a
    # statement's findings share a site), and no marker is stale.
    findings, modules = _audit()
    assert all(modules[f.file].suppressed(f) for f in findings)
    assert len(findings) == SUPPRESSED
    sites = {(f.file, f.line, f.rule) for f in findings}
    markers = _markers()
    assert len(sites) == len(markers)
    assert {(f, line) for f, line, _ in sites} == set(markers)


def test_cli_gate_is_clean_from_any_cwd(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    rc = graftlint_main([str(PORT), "--no-suppressions", "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["ok"] and doc["findings"] == []
    assert doc["baselined"] == 0
    assert len(doc["suppressed"]) == SUPPRESSED
    assert {f["file"] for f in doc["suppressed"]} == \
        {f.file for f in _audit()[0]}


@pytest.mark.parametrize("respect", [True, False], ids=["gated", "audit"])
def test_reference_linter_agrees_on_the_port(respect):
    # The JAX package's linter, on the ported rules, sees the port as
    # the port's linter does: clean when suppressions count, and the
    # same audit list when they do not.
    port = _gated() if respect else _audit()[0]
    ref = _ref_audit()
    if respect:
        _, modules = _audit()
        ref = [f for f in ref if not modules[f.file].suppressed(f)]
        assert ref == [] and port == []
    else:
        # The reference does not know the port's seam, so it sees the
        # port's seam-built locks by name only (``self._cond`` for
        # ``SimService._cond``) and misses the guard findings they carry.
        def key(r):
            return r[:5]
        port_keys = {key(r) for r in rows(port)}
        assert {key(r) for r in rows(ref)} <= port_keys
        assert {r[0] for r in rows(port)} <= set(PORTED) | set(PORT_ONLY)


# ------------------------------------------------- the kernel build's lock

_FAKE_NVCC = """\
#!{python}
import os, shutil, sys, time, _ctypes
mode = os.environ.get("FAKE_NVCC_MODE", "ok")
out = sys.argv[sys.argv.index("-o") + 1]
if mode == "hang":
    time.sleep(60)
if mode == "fail" and "-c" in sys.argv:
    time.sleep(float(os.environ.get("FAKE_NVCC_DELAY", "0")))
    print("error: fake nvcc refuses", os.path.basename(sys.argv[-3]))
    sys.exit(1)
if "-shared" in sys.argv:
    shutil.copy(_ctypes.__file__, out)
else:
    time.sleep(float(os.environ.get("FAKE_NVCC_DELAY", "0")))
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


def _race():
    """``library()`` from more threads than cores at once, the switch
    interval shortened: each thread's library or error."""
    n = min((os.cpu_count() or 2) + 2, 16)
    out = [None] * n

    def call(i):
        try:
            out[i] = _build.library()
        except BaseException as e:  # noqa: BLE001 - collected for the test
            out[i] = e

    ts = [threading.Thread(target=call, args=(i,)) for i in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    return out


def test_build_hang_raises_naming_the_source(fake_build):
    fake_build.setenv("FAKE_NVCC_MODE", "hang")
    fake_build.setattr(_build, "NVCC_TIMEOUT_S", 0.5)
    with pytest.raises(RuntimeError, match=r"nvcc did not finish k\.cu"):
        _build.library()
    assert _build._lib is None and _build._building is None


def test_failed_build_raises_for_every_caller(fake_build):
    fake_build.setenv("FAKE_NVCC_MODE", "fail")
    fake_build.setenv("FAKE_NVCC_DELAY", "0.5")
    out = _race()
    assert all(isinstance(e, RuntimeError) for e in out), out
    builder = [e for e in out if "nvcc failed on k.cu" in str(e)]
    waiters = [e for e in out if "build failed" in str(e)]
    assert len(builder) == 1 and len(waiters) == len(out) - 1
    assert all(e.__cause__ is builder[0] for e in waiters)
    # Nothing is published: the next call builds again.
    assert _build._lib is None and _build._building is None


def test_one_build_serves_concurrent_callers(fake_build):
    fake_build.setenv("FAKE_NVCC_DELAY", "0.5")
    out = _race()
    assert all(lib is out[0] for lib in out), out
    assert _build.LAST_BUILD["compiled"] is True
    assert len(list((_build.OUT_DIR).glob("libp2p_kernels-*.so"))) == 1
    assert _build.library() is out[0]
    assert os.path.basename(_build.LAST_BUILD["path"]).startswith(
        "libp2p_kernels-")
