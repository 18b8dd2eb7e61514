"""The port's graftlint (``p2pnetwork_tpu_torch/analysis/``) held against
the JAX package's: the same findings, entry for entry, on the reference
tests' rule fixtures (copied here) and on the reference's own lock-using
modules, with suppressions on and off; the baseline's round trips; and
the CLI's exit codes and JSON document.

Both linters run restricted to the rules the port has (the eight lock
rules and ``unbounded-cache``). Messages are compared with the package
name folded (``p2pnetwork_tpu_torch`` -> ``p2pnetwork_tpu``): the port's
seam hint names its own package. A fixture's ``from p2pnetwork_tpu
import concurrency`` reaches the port's linter as the port's seam.
"""

import json
import os
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from p2pnetwork_tpu.analysis import core as ref_core  # noqa: E402
from p2pnetwork_tpu.analysis.__main__ import main as ref_main  # noqa: E402
from p2pnetwork_tpu_torch import analysis  # noqa: E402
from p2pnetwork_tpu_torch.analysis import core  # noqa: E402
from p2pnetwork_tpu_torch.analysis.__main__ import (  # noqa: E402
    _resolve_root, main as graftlint_main,
)
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401

pytestmark = [pytest.mark.analysis, pytest.mark.usefixtures("one_torch_thread")]

ROOT = Path(__file__).resolve().parent.parent

PORTED = ("lock-order-cycle", "lock-across-await", "blocking-under-lock",
          "async-blocking-call", "lock-guard", "lock-open-call",
          "raw-concurrency-primitive", "wait-untimed", "unbounded-cache")
#: The port's torch form of a reference rule: the reference's
#: ``host-sync-in-loop`` reads modules that import jax, the port's those
#: that import torch, so the two never judge one module alike.
PORT_ONLY = ("host-sync-in-loop",)


def ref_rules():
    rules = ref_core.all_rules()
    return {r: rules[r] for r in PORTED}


def rows(findings):
    """(rule, severity, file, line, col, message), the package folded."""
    return [(f.rule, f.severity, f.file, f.line, f.col,
             f.message.replace("p2pnetwork_tpu_torch", "p2pnetwork_tpu"))
            for f in findings]


def to_port(source: str) -> str:
    return source.replace("from p2pnetwork_tpu import",
                          "from p2pnetwork_tpu_torch import")


def lint_both(source: str, respect: bool = True):
    source = textwrap.dedent(source)
    ref = ref_core.analyze_source(source, path="snippet.py",
                                  rules=ref_rules(),
                                  respect_suppressions=respect)
    port = core.analyze_source(to_port(source), path="snippet.py",
                               respect_suppressions=respect)
    return rows(ref), rows(port)


def hot_lines(source: str):
    return [i for i, ln in enumerate(textwrap.dedent(source).splitlines(), 1)
            if "# HOT" in ln]


# The reference tests' fixtures for the ported rules
# (tests/test_analysis.py), keyed by the test they come from.
FIXTURES = {
    "unbounded_cache_fires_at_declaration": """\
    _CACHE = {}  # HOT

    def lookup(key, build):
        if key not in _CACHE:
            _CACHE[key] = build(key)
        return _CACHE[key]

    def warm(keys, build):
        for k in keys:
            _CACHE.setdefault(k, build(k))
""",
    "unbounded_cache_class_attr_fires": """\
    class Planner:
        _memo = {}  # HOT

        def plan(self, key):
            self._memo[key] = key * 2
            return self._memo[key]
""",
    "bounded_cache_is_clean": """\
    _CACHE = {}

    def lookup(key, build):
        if len(_CACHE) > 128:
            _CACHE.clear()
        _CACHE[key] = build(key)
        return _CACHE[key]

    _PLAIN = {}  # written nowhere: data, not a cache
""",
    "lock_order_cycle_fires": """\
    import threading

    a = threading.Lock()
    b = threading.Lock()

    def forward():
        with a:
            with b:
                pass

    def backward():
        with b:
            with a:  # HOT
                pass
""",
    "consistent_lock_order_is_clean": """\
    import threading

    a = threading.Lock()
    b = threading.Lock()

    def one():
        with a:
            with b:
                pass

    def two():
        with a:
            with b:
                pass
""",
    "nonreentrant_self_deadlock_via_call": """\
    import threading

    L = threading.Lock()

    def outer():
        with L:
            inner()  # HOT

    def inner():
        with L:
            pass
""",
    "rlock_reentry_is_clean": """\
    import threading

    L = threading.RLock()

    def outer():
        with L:
            inner()

    def inner():
        with L:
            pass
""",
    "blocking_under_lock_direct": """\
    import threading
    import time

    L = threading.Lock()

    def f():
        with L:
            time.sleep(1)  # HOT
""",
    "blocking_under_lock_through_call_edge": """\
    import threading
    import time

    L = threading.Lock()

    def helper():
        time.sleep(0.1)

    def f():
        with L:
            helper()  # HOT
""",
    "blocking_outside_lock_is_clean": """\
    import threading
    import time

    L = threading.Lock()

    def f():
        with L:
            n = 1
        time.sleep(n)
""",
    "untimed_queue_get_under_lock": """\
    import queue
    import threading

    L = threading.Lock()
    work_queue = queue.Queue()

    def f():
        with L:
            item = work_queue.get()  # HOT
        return item
""",
    "lock_across_await_fires": """\
    import threading

    L = threading.Lock()

    async def f(peer):
        with L:
            await peer.flush()  # HOT
""",
    "copy_then_await_is_clean": """\
    import threading

    L = threading.Lock()
    items = []

    async def f(peer):
        with L:
            snapshot = list(items)
        await peer.send(snapshot)
""",
    "async_blocking_call_fires": """\
    import time

    async def f():
        time.sleep(1)  # HOT
""",
    "awaited_asyncio_wait_is_clean": """\
    import asyncio

    async def f(ev):
        await asyncio.wait_for(ev.wait(), timeout=2.0)
        await asyncio.sleep(0.1)
""",
    "async_blocking_through_call_edge": """\
    import time

    def helper():
        time.sleep(0.5)

    async def f():
        helper()  # HOT
""",
    "lock_guard_class_attr_fires": """\
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._items = {}

        def put(self, k, v):
            with self._lock:
                self._items[k] = v

        def peek(self, k):
            return self._items.get(k)  # HOT
""",
    "lock_guard_consistent_class_is_clean": """\
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._items = {}

        def put(self, k, v):
            with self._lock:
                self._items[k] = v

        def peek(self, k):
            with self._lock:
                return self._items.get(k)
""",
    "lock_guard_module_global_fires": """\
    import threading

    _lock = threading.Lock()
    _state = {}

    def set_state(s):
        global _state
        with _lock:
            _state = s

    def get_state():
        return _state  # HOT
""",
    "lock_open_call_fires": """\
    import threading

    class Pub:
        def __init__(self, sink):
            self._lock = threading.Lock()
            self._n = 0
            self._sink = sink

        def bump(self):
            with self._lock:
                self._n += 1
                self._sink.publish(self._n)  # HOT
""",
    "lock_open_call_names_derived_receiver": """\
    import threading

    class Store:
        def __init__(self):
            self._lock = threading.Lock()
            self._crdts = {}

        def absorb(self, name, incoming):
            with self._lock:
                mine = self._crdts.get(name)
                merged = mine.merge(incoming)  # HOT
""",
    "lock_open_call_copy_then_call_is_clean": """\
    import threading

    class Pub:
        def __init__(self, sink):
            self._lock = threading.Lock()
            self._n = 0
            self._sink = sink

        def bump(self):
            with self._lock:
                self._n += 1
                n = self._n
            self._sink.publish(n)
""",
    "wait_untimed_fires_and_timed_is_clean": """\
    def bad(ev):
        ev.wait()  # HOT

    def good(ev):
        return ev.wait(5.0)
""",
    "wait_untimed_result_and_join": """\
    def bad(fut, thread):
        fut.result()    # HOT-RESULT
        thread.join()   # HOT-JOIN

    def fine(parts):
        return ",".join(parts)
""",
    "raw_concurrency_primitive_fires_per_construction": """\
    import queue
    import threading
    import time
    from threading import Event

    def build():
        lk = threading.Lock()     # HOT-LOCK
        ev = Event()              # HOT-EVENT
        q = queue.Queue()         # HOT-QUEUE
        time.sleep(0.1)           # HOT-SLEEP
        return lk, ev, q
""",
    "raw_concurrency_primitive_seam_twin_is_clean": """\
    import threading
    from p2pnetwork_tpu import concurrency

    _tls = threading.local()

    def build():
        lk = concurrency.lock()
        ev = concurrency.event()
        q = concurrency.fifo_queue()
        concurrency.sleep(0.1)
        me = threading.current_thread()
        return lk, ev, q, me
""",
    "seam_factories_join_the_lock_inventory": """\
    from p2pnetwork_tpu import concurrency

    class C:
        def __init__(self):
            self._mu = concurrency.lock()
            self.state = {}

        def put(self, k, v):
            with self._mu:
                self.state[k] = v

        def peek(self):
            return self.state  # HOT
""",
    "seam_sleep_is_blocking_under_lock": """\
    import threading
    from p2pnetwork_tpu import concurrency

    L = threading.Lock()

    def f():
        with L:
            concurrency.sleep(1)  # HOT
""",
    "standalone_comment_does_not_silence_enclosing_block": """\
    import threading
    import time

    L = threading.Lock()

    def f(ev):
        # graftlint: ignore -- stray comment, binds to nothing
        ev.wait()  # HOT-WAIT
        with L:
            time.sleep(1)  # HOT-SLEEP
""",
    "header_suppression_covers_header_not_body": """\
    import threading
    import time

    L = threading.Lock()

    def f(ev):
        with L:  # graftlint: ignore[blocking-under-lock] -- t
            time.sleep(1)  # HOT
""",
}


BLOCKING = """\
    import threading
    import time

    L = threading.Lock()

    def f():
        with L:
            time.sleep(1){suffix}
"""

#: tests/test_analysis.py's suppression fixtures: the marker's forms on
#: the flagged line.
SUPPRESSED = {
    "none": "",
    "one_rule": "  # graftlint: ignore[blocking-under-lock] -- test",
    "bare": "  # graftlint: ignore",
    "unknown_rule": "  # graftlint: ignore[some-other-rule]",
}

#: A marker on a continuation line covers the statement's first line
#: (the reference's multi-line fixture, on a ported rule).
MULTILINE = """\
    import threading

    class Pub:
        def __init__(self, sink):
            self._lock = threading.Lock()  # graftlint: ignore[raw-concurrency-primitive] -- t
            self._sink = sink

        def bump(self, n):
            with self._lock:
                self._sink.publish(
                    n)  # graftlint: ignore[lock-open-call] -- t
"""

LEAK = BLOCKING.format(suffix="") + """\

    def g():
        with L:
            time.sleep(2)  # graftlint: ignore[blocking-under-lock]
"""


def test_rule_set_is_the_ported_nine():
    assert set(core.all_rules()) == set(PORTED) | set(PORT_ONLY)
    ref = ref_core.all_rules()
    for rid, rule in core.all_rules().items():
        assert rule.severity == ref[rid].severity


@pytest.mark.parametrize("respect", [True, False], ids=["suppressed", "audit"])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_rule_fixture_matches_reference(name, respect):
    src = FIXTURES[name]
    ref, port = lint_both(src, respect)
    assert port == ref
    found = {line for _, _, _, line, _, _ in ref}
    assert set(hot_lines(src)) <= found, (name, ref)


@pytest.mark.parametrize("respect", [True, False], ids=["suppressed", "audit"])
@pytest.mark.parametrize("form", sorted(SUPPRESSED))
def test_suppression_forms_match_reference(form, respect):
    src = BLOCKING.format(suffix=SUPPRESSED[form])
    if form == "bare":
        src = src.replace("L = threading.Lock()",
                          "L = threading.Lock()  # graftlint: ignore")
    ref, port = lint_both(src, respect)
    assert port == ref
    blocked = [r for r in port if r[0] == "blocking-under-lock"]
    silenced = respect and form in ("one_rule", "bare")
    assert bool(blocked) != silenced


@pytest.mark.parametrize("respect", [True, False], ids=["suppressed", "audit"])
@pytest.mark.parametrize("src", [MULTILINE, LEAK], ids=["multiline", "leak"])
def test_statement_scope_of_markers_matches_reference(src, respect):
    ref, port = lint_both(src, respect)
    assert port == ref
    if src is LEAK:
        assert len([r for r in port if r[0] == "blocking-under-lock"]) \
            == (1 if respect else 2)
    else:
        assert bool([r for r in port if r[0] == "lock-open-call"]) \
            != respect


# ------------------------------------------- the reference's own modules

REF_MODULES = sorted(
    str(p.relative_to(ROOT)) for pat in (
        "node.py", "nodeconnection.py", "phi.py", "crdt.py",
        "serve/service.py", "supervise/*.py", "telemetry/*.py",
        "chaos/plane.py")
    for p in (ROOT / "p2pnetwork_tpu").glob(pat))


def lint_file_both(rel: str, respect: bool):
    path = str(ROOT / rel)
    ref = ref_core.analyze_paths([path], rules=ref_rules(), root=str(ROOT),
                                 respect_suppressions=respect)
    port = core.analyze_paths([path], root=str(ROOT),
                              respect_suppressions=respect)
    return rows(ref), rows(port)


@pytest.mark.parametrize("respect", [True, False], ids=["suppressed", "audit"])
@pytest.mark.parametrize("rel", REF_MODULES)
def test_reference_module_matches_reference(rel, respect):
    ref, port = lint_file_both(rel, respect)
    assert port == ref


def test_reference_modules_have_teeth():
    # With suppressions off the reference tree is not clean, so the
    # per-module comparison above compares findings, not two empties.
    audit = sum(len(lint_file_both(rel, False)[0]) for rel in REF_MODULES)
    gated = sum(len(lint_file_both(rel, True)[0]) for rel in REF_MODULES)
    assert gated == 0 and audit >= 30, (gated, audit)
    assert len(REF_MODULES) >= 15


# ------------------------------------------------------------- baseline

def _tree(tmp_path, source, name="mod.py"):
    (tmp_path / name).write_text(textwrap.dedent(source))


def _baseline_doc(mod, tmp_path, out):
    modules = {}
    kw = {"rules": ref_rules()} if mod is ref_core else {}
    findings = mod.analyze_paths([str(tmp_path / "mod.py")],
                                 root=str(tmp_path), collect_sources=modules,
                                 **kw)
    mod.write_baseline(findings, modules, str(out))
    return findings, modules, json.loads(out.read_text())


def test_baseline_file_equals_reference(tmp_path):
    _tree(tmp_path, LEAK)
    _, _, port_doc = _baseline_doc(core, tmp_path, tmp_path / "p.json")
    _, _, ref_doc = _baseline_doc(ref_core, tmp_path, tmp_path / "r.json")
    assert port_doc == ref_doc and port_doc["findings"]
    assert core.load_baseline(str(tmp_path / "r.json")) == \
        ref_core.load_baseline(str(tmp_path / "p.json"))


def test_baseline_roundtrip_and_line_drift(tmp_path):
    _tree(tmp_path, BLOCKING.format(suffix=""))
    findings, modules, _ = _baseline_doc(core, tmp_path, tmp_path / "b.json")
    baseline = core.load_baseline(str(tmp_path / "b.json"))
    new, old = core.apply_baseline(findings, modules, baseline)
    assert new == [] and len(old) == len(findings) > 0
    drifted = "# a new leading comment\n\n" + \
        textwrap.dedent(BLOCKING.format(suffix=""))
    (tmp_path / "mod.py").write_text(drifted)
    modules2 = {}
    findings2 = core.analyze_paths([str(tmp_path / "mod.py")],
                                   root=str(tmp_path),
                                   collect_sources=modules2)
    new2, old2 = core.apply_baseline(findings2, modules2, baseline)
    assert new2 == [] and len(old2) == len(findings2)


def test_baseline_does_not_absorb_new_duplicates(tmp_path):
    _tree(tmp_path, BLOCKING.format(suffix=""))
    findings, _, _ = _baseline_doc(core, tmp_path, tmp_path / "b.json")
    (tmp_path / "mod.py").write_text(textwrap.dedent(LEAK).replace(
        "  # graftlint: ignore[blocking-under-lock]", ""))
    modules2 = {}
    findings2 = core.analyze_paths([str(tmp_path / "mod.py")],
                                   root=str(tmp_path),
                                   collect_sources=modules2)
    new2, old2 = core.apply_baseline(
        findings2, modules2, core.load_baseline(str(tmp_path / "b.json")))
    assert len(old2) == len(findings)
    assert len(new2) == len(findings2) - len(findings) > 0


@pytest.mark.parametrize("content", [b"def broken(:\n", b"x = 1\x00\n"],
                         ids=["syntax", "nul"])
def test_unparsable_file_is_a_finding_not_a_crash(tmp_path, content):
    (tmp_path / "bad.py").write_bytes(content)
    port = core.analyze_paths([str(tmp_path)], root=str(tmp_path))
    ref = ref_core.analyze_paths([str(tmp_path)], root=str(tmp_path))
    assert [f.rule for f in port] == ["parse-error"]
    assert rows(port) == rows(ref)


# ------------------------------------------------------------------ CLI

def test_cli_exit_codes(tmp_path, capsys, monkeypatch):
    _tree(tmp_path, BLOCKING.format(suffix=""))
    monkeypatch.chdir(tmp_path)
    bl = tmp_path / "bl.json"
    assert graftlint_main(["mod.py", "--baseline", str(bl)]) == 1
    out = capsys.readouterr().out
    assert "blocking-under-lock" in out and "mod.py:" in out
    assert graftlint_main(["mod.py", "--baseline", str(bl),
                           "--write-baseline"]) == 0
    assert graftlint_main(["mod.py", "--baseline", str(bl)]) == 0
    assert "clean" in capsys.readouterr().out
    # A typo'd target is a broken invocation, never a clean tree.
    assert graftlint_main(["no_such_dir_xyz", "--baseline", str(bl)]) == 2
    assert "no such file" in capsys.readouterr().err
    # A filtered run may not overwrite the baseline.
    assert graftlint_main(["mod.py", "--baseline", str(tmp_path / "f.json"),
                           "--rules", "wait-untimed",
                           "--write-baseline"]) == 2
    assert not (tmp_path / "f.json").exists()


def test_cli_json_document_equals_reference(tmp_path, monkeypatch, capsys):
    _tree(tmp_path, LEAK)
    (tmp_path / "w.py").write_text("def bad(ev):\n    ev.wait()\n")
    monkeypatch.chdir(tmp_path)
    args = ["mod.py", "w.py", "--json", "--no-suppressions", "--baseline",
            str(tmp_path / "none.json")]
    rc = graftlint_main(args)
    port = json.loads(capsys.readouterr().out)
    rc_ref = ref_main(args + ["--rules", ",".join(PORTED)])
    ref = json.loads(capsys.readouterr().out)
    assert rc == rc_ref == 1 and port["ok"] is False
    assert port == ref
    assert {f["rule"] for f in port["findings"]} >= {
        "blocking-under-lock", "wait-untimed"}
    assert port["suppressed"][0]["rule"] == "blocking-under-lock"


def test_cli_audit_view_keeps_exit_code(tmp_path, monkeypatch, capsys):
    _tree(tmp_path, """\
        def f(ev):
            ev.wait()  # graftlint: ignore[wait-untimed] -- test
    """)
    monkeypatch.chdir(tmp_path)
    bl = str(tmp_path / "bl.json")
    assert graftlint_main(["mod.py", "--baseline", bl]) == 0
    capsys.readouterr()
    assert graftlint_main(["mod.py", "--baseline", bl,
                           "--no-suppressions"]) == 0
    out = capsys.readouterr().out
    assert "suppressed finding" in out and "wait-untimed" in out


def test_cli_severity_filter_and_list_rules(tmp_path, monkeypatch, capsys):
    _tree(tmp_path, LEAK)
    monkeypatch.chdir(tmp_path)
    bl = str(tmp_path / "bl.json")
    # The file's findings are P1 (the sleep) and P2 (the raw lock).
    assert graftlint_main(["mod.py", "--baseline", bl, "--severity",
                           "P0"]) == 0
    assert graftlint_main(["mod.py", "--baseline", bl, "--severity",
                           "P1"]) == 1
    capsys.readouterr()
    assert graftlint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(rule in out for rule in PORTED)


def test_write_baseline_path_subset_keeps_other_files(tmp_path,
                                                      monkeypatch):
    (tmp_path / "a.py").write_text("def f(ev):\n    ev.wait()\n")
    (tmp_path / "b.py").write_text("def g(ev):\n    ev.wait()\n")
    monkeypatch.chdir(tmp_path)
    bl = tmp_path / "bl.json"
    assert graftlint_main(["a.py", "b.py", "--baseline", str(bl),
                           "--write-baseline"]) == 0
    assert graftlint_main(["a.py", "--baseline", str(bl),
                           "--write-baseline"]) == 0
    assert graftlint_main(["a.py", "b.py", "--baseline", str(bl)]) == 0
    assert {e["file"] for e in json.loads(bl.read_text())["findings"]} \
        == {"a.py", "b.py"}
    (tmp_path / "a.py").write_text("def f(ev):\n    ev.wait(1.0)\n")
    assert graftlint_main(["a.py", "--baseline", str(bl),
                           "--write-baseline"]) == 0
    assert {e["file"] for e in json.loads(bl.read_text())["findings"]} \
        == {"b.py"}


def test_root_resolves_to_repo_root_from_subdir(monkeypatch):
    pkg_dir = os.path.dirname(os.path.abspath(analysis.__file__))
    monkeypatch.chdir(pkg_dir)
    assert _resolve_root(None, ["core.py"]) == str(ROOT)
