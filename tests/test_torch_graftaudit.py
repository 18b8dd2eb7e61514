"""graftaudit for the port (``p2pnetwork_tpu_torch/analysis/ir/``), held
against the JAX package's graftaudit on the CPU.

- **the registry**: the port's names hold the reference's 44 with the same
  op, variant, shape-class, parity group and slot budget, plus the
  segment-sum kernel's four routes; each entry the reference traces here
  gives the same output signature (dtypes mapped: the reference's u32
  lane words are the port's i32 bits, its i32 counters the port's i64),
  and on the same seeded inputs the same values;
- **the rules**, each planted: an unplanned ``.item()``, an f64 cast, a
  broken compaction, a mismatched parity group, a carry kept in a list;
- **the ratchets**: the checked-in budgets and membudgets match head, an
  inflated cost fails, a shrunk one asks for a re-bless;
- **the CLI**: ``--json`` head is clean, ``--no-cost`` is fast,
  ``--write-budgets`` round-trips, no ``--device`` asks for the card;
- ``host-sync-in-loop``, graftlint's rule, on planted loops.
"""

import copy
import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from p2pnetwork_tpu.analysis.ir import registry as ref_registry  # noqa: E402
from p2pnetwork_tpu.parallel import commviz as ref_commviz  # noqa: E402
from p2pnetwork_tpu_torch.analysis import core  # noqa: E402
from p2pnetwork_tpu_torch.analysis.ir import budgets as B  # noqa: E402
from p2pnetwork_tpu_torch.analysis.ir import donation  # noqa: E402
from p2pnetwork_tpu_torch.analysis.ir import memory as M  # noqa: E402
from p2pnetwork_tpu_torch.analysis.ir import registry, rules  # noqa: E402
from p2pnetwork_tpu_torch.analysis.ir.registry import Lowering  # noqa: E402
from p2pnetwork_tpu_torch.parallel import commviz  # noqa: E402
from tests.test_torch_graph import one_torch_thread  # noqa: E402,F401

pytestmark = [pytest.mark.audit, pytest.mark.usefixtures("one_torch_thread")]

#: The reference's entry that does not trace on this jax (its Pallas ring
#: kernel needs ``pltpu.TPUMemorySpace``); the port's is held to the
#: reference's ``ringstep/ppermute`` output instead.
REF_UNTRACEABLE = "ringstep/pallas@ws1k"
#: The segment-sum kernel's routes the reference leaves out.
B1_ROUTES = ("or/pallas@ws1k", "or/hybrid@ws1k", "sum/pallas@ws1k",
             "sum/hybrid@ws1k")
REF_NAMES = [e.name for e in ref_registry.all_lowerings()]
#: f32 outputs held to the reference within the segment sum's own
#: tolerance (``ops/segsum.py``: sums whose order of adds differs); every
#: other output is compared by its bits.
SUM_RTOL = SUM_ATOL = 1e-5


@pytest.fixture(scope="module")
def traces():
    """One run of the port's registry on the CPU, with the tracker and
    the log (what the CLI's gate runs)."""
    return {e.name: registry.trace_lowering(e, "cpu")
            for e in registry.all_lowerings()}


@pytest.fixture(scope="module")
def ref_entries():
    return {e.name: e for e in ref_registry.all_lowerings()}


def _entry(name, build, **kw):
    op, rest = name.split("/", 1)
    variant, cls = rest.split("@", 1)
    return Lowering(name=name, op=op, variant=variant, shape_class=cls,
                    build=build, **kw)


def _sig(n=128, dtype=torch.float32):
    return torch.zeros(n, dtype=dtype)


def test_package_import_stays_torch_free():
    code = ("import sys; import p2pnetwork_tpu_torch.analysis.ir; "
            "sys.exit(2 if 'torch' in sys.modules else 0)")
    assert subprocess.run([sys.executable, "-c", code]).returncode == 0


# ------------------------------------------------------------- registry


def test_names_hold_the_reference_and_the_b1_routes(ref_entries):
    port = {e.name: e for e in registry.all_lowerings()}
    assert len(ref_entries) == 44
    assert set(port) == set(ref_entries) | set(B1_ROUTES)
    for name, ref in ref_entries.items():
        mine = port[name]
        assert (mine.op, mine.variant, mine.shape_class, mine.parity,
                mine.slot_budget) == (ref.op, ref.variant, ref.shape_class,
                                      ref.parity, ref.slot_budget), name
        assert mine.n_shards == ref.needs_devices


def test_full_registry_traces_clean(traces):
    assert [n for n, t in traces.items() if t.error] == []
    for t in traces.values():
        assert t.out_sig and t.census.launches > 0, t.entry.name


def test_kernel_routes_count_their_kernels(traces):
    want = {"or/pallas@ws1k": {"segsum_or": 1},
            "or/hybrid@ws1k": {"segsum_or": 1},
            "sum/pallas@ws1k": {"segsum_sum": 1},
            "sum/hybrid@ws1k": {"segsum_sum": 1},
            "ringstep/pallas@ws1k": {"ring_segsum_or": 7, "segsum_or": 1}}
    for name, kernels in want.items():
        assert traces[name].census.kernels == kernels, name
    # The plain twins' calls are not counted: a pallas route is its
    # launch and the few calls around it.
    assert traces["or/pallas@ws1k"].census.launches <= 4


def test_ring_entries_census_their_exchanges(traces):
    t = traces["cov/flood-ppermute@ws1k"]
    rounds = t.leaves[2][0].item()
    assert t.exchanges == {"hops": 7 * rounds}
    assert t.ici_bytes_est == 7 * rounds * 128
    assert traces["ringstep/ppermute@ws1k"].exchanges == {"hops": 7}
    for name, t in traces.items():
        if t.entry.n_shards == 1:
            assert not t.exchanges, name


def _norm(sig: str) -> str:
    """The reference's u32 words are the port's i32 bits; its i32
    counters the port's i64."""
    return sig.replace("uint32", "int32").replace("int64", "int32")


def _ref_sig(ref_entries, name):
    t = ref_registry.trace_lowering(ref_entries[name])
    assert t.error is None, t.error
    return t.out_sig


@pytest.mark.parametrize("name", [n for n in REF_NAMES
                                  if n != REF_UNTRACEABLE])
def test_signature_equals_reference(traces, ref_entries, name):
    assert _norm(traces[name].out_sig) == \
        _norm(_ref_sig(ref_entries, name))


def test_untraceable_reference_entry_is_the_known_one(ref_entries):
    bad = [n for n, e in ref_entries.items()
           if ref_registry.trace_lowering(e).error is not None]
    assert bad == [REF_UNTRACEABLE]


# ----------------------------------------------------------------- values


def _ref_args(name, fn, args):
    """The reference entry's arguments with the port's seeded inputs in
    place of its zeros (the same numpy arrays)."""
    from p2pnetwork_tpu.parallel import mesh as JM
    from p2pnetwork_tpu.parallel import sharded as JS

    op = name.split("/", 1)[0]
    cls = name.rsplit("@", 1)[1]
    g = ref_registry.shape_class(cls)
    n = g.n_nodes_padded
    kinds = {"or": "bool", "sum": "sum", "max": "max", "minplus": "minplus"}
    if op in kinds:
        return (jnp.asarray(registry.seeded_signal(n, kinds[op])),)
    if op == "floodstep":
        return tuple(jnp.asarray(a) for a in registry.seeded_flood_state(n))
    if op == "or_lanes" and "sharded" in name:
        sg = JS.shard_graph(g, JM.ring_mesh(8))
        lanes = JS.shard_lanes(sg, jnp.asarray(registry.seeded_lanes(n)))
        return args[:-1] + (lanes,)
    if op == "or_lanes":
        return (jnp.asarray(registry.seeded_lanes(n)),)
    if op in ("minplus_lanes", "sum_lanes"):
        return (jnp.asarray(registry.seeded_lane_matrix(n, op)),)
    if op == "dht_hop":
        return tuple(jnp.asarray(a) for a in registry.seeded_dht(g.n_nodes))
    if op == "ringstep":
        seed = registry.seeded_signal(n, "bool").reshape(8, n // 8)
        return args[:-1] + (jnp.asarray(seed),)
    return args


def _ref_leaves(ref_entries, name):
    fn, args = ref_entries[name].build()
    out = fn(*_ref_args(name, fn, args))
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(out)]


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype in (np.float32, np.int32, np.uint32):
        return a.view(np.int32)
    if a.dtype == np.int64:
        return a.astype(np.int32)
    return a


@pytest.mark.parametrize("name", REF_NAMES)
def test_values_equal_reference(traces, ref_entries, name):
    ref_name = "ringstep/ppermute@ws1k" if name == REF_UNTRACEABLE \
        else name
    want = _ref_leaves(ref_entries, ref_name)
    got = [t.detach().cpu().numpy() for t in traces[name].leaves]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (name, i)
        if w.dtype == np.float32 and name.split("/")[0] in (
                "sum", "sum_lanes"):
            np.testing.assert_allclose(g, w, rtol=SUM_RTOL, atol=SUM_ATOL,
                                       err_msg=f"{name} leaf {i}")
        else:
            np.testing.assert_array_equal(_bits(g), _bits(w),
                                          err_msg=f"{name} leaf {i}")


@pytest.mark.parametrize("prim", ["ppermute", "psum", "pmax", "pmin",
                                  "all_gather", "all_to_all",
                                  "reduce_scatter", "ring_dma", "other"])
@pytest.mark.parametrize("axis", [1, 2, 8, 64])
def test_ring_model_bytes_equals_reference(prim, axis):
    for nbytes in (0, 4, 512, 12_345, 1 << 20):
        assert commviz.ring_model_bytes(prim, nbytes, axis) == \
            ref_commviz.ring_model_bytes(prim, nbytes, axis)


# ------------------------------------------------------------------ rules


def test_real_registry_has_only_the_grandfathered_findings(traces):
    found = rules.run_ir_rules(list(traces.values()))
    new, old = rules.apply_ir_baseline(found, rules.load_ir_baseline())
    assert new == [] and [f.rule for f in old] == ["ir-f64-widen"]
    for key, (count, reason) in rules.load_ir_baseline().items():
        assert count >= 1 and len(reason) > 40, key


def test_item_in_a_lowering_fires_host_sync():
    def build(device):
        def bad(x):
            return x * float(x.sum().item())
        return bad, (_sig(),), None

    t = registry.trace_lowering(_entry("sum/item@ws1k", build,
                                       parity=False), "cpu")
    found = rules.run_ir_rules([t])
    assert [f.rule for f in found] == ["ir-host-sync"]
    assert found[0].severity == "P0" and found[0].file == "sum/item@ws1k"
    assert rules.anchor(found[0]) == "Tensor.item"


def test_counted_read_is_declared():
    from p2pnetwork_tpu_torch import _device

    def build(device):
        def ok(x):
            return x * 2 if _device.host_bool(x.sum() > 0) else x
        return ok, (_sig(),), None

    t = registry.trace_lowering(_entry("sum/counted@ws1k", build,
                                       parity=False), "cpu")
    assert rules.run_ir_rules([t]) == []
    assert t.census.reads == {"Tensor.item": 1} and t.census.declared == 1


def test_f64_cast_fires_at_the_call_name():
    def build(device):
        def bad(x):
            return (x.to(torch.float64) * 2.0).to(torch.float32)
        return bad, (_sig(),), None

    t = registry.trace_lowering(_entry("sum/f64bad@ws1k", build,
                                       parity=False), "cpu")
    found = [f for f in rules.run_ir_rules([t]) if f.rule == "ir-f64-widen"]
    assert [rules.anchor(f) for f in found] == ["Tensor.to"]
    assert found[0].file == "sum/f64bad@ws1k"


def test_f64_clean_twin():
    def build(device):
        return (lambda x: x * 2.0), (_sig(),), None

    t = registry.trace_lowering(_entry("sum/f32ok@ws1k", build,
                                       parity=False), "cpu")
    assert rules.run_ir_rules([t]) == []


def test_trace_error_is_a_finding_not_a_crash():
    def build(device):
        raise RuntimeError("entry rotted")

    t = registry.trace_lowering(_entry("or/dead@ws1k", build), "cpu")
    found = rules.run_ir_rules([t])
    assert [f.rule for f in found] == ["ir-trace-error"]
    assert "entry rotted" in found[0].message


def test_broken_compaction_fires_the_slot_rule():
    idx = torch.arange(4096) % 128

    def build(device):
        return (lambda x: x[idx]), (_sig(dtype=torch.bool),), None

    t = registry.trace_lowering(_entry("or/fatgather@ws1k", build,
                                       parity=False, slot_budget=64), "cpu")
    found = [f for f in rules.run_ir_rules([t])
             if f.rule == "ir-gather-slot-budget"]
    assert found and found[0].file == "or/fatgather@ws1k"
    assert "4096 slots" in found[0].message


def test_compaction_taken_out_fires_the_slot_rule():
    def build(device):
        return (lambda x: x * 2), (_sig(),), None

    t = registry.trace_lowering(_entry("or/nogather@ws1k", build,
                                       parity=False, slot_budget=64), "cpu")
    found = [f for f in rules.run_ir_rules([t])
             if f.rule == "ir-gather-slot-budget"]
    assert found and "taken out" in found[0].message


def test_real_frontier_entries_keep_their_budget(traces):
    budgeted = [t for t in traces.values() if t.entry.slot_budget]
    assert len(budgeted) == 4
    for t in budgeted:
        assert max(t.census.slots.values()) <= t.entry.slot_budget
    assert [f for t in budgeted for f in rules.run_ir_rules([t])
            if f.rule == "ir-gather-slot-budget"] == []


def test_real_registry_is_parity_clean(traces):
    assert rules.parity_findings(list(traces.values())) == []


def test_mismatched_group_fires_parity(traces):
    def build(device):
        return (lambda x: x.to(torch.int32)), (
            _sig(1024, dtype=torch.bool),), None

    bad = registry.trace_lowering(_entry("or/badsig@ws1k", build), "cpu")
    found = rules.parity_findings(list(traces.values()) + [bad])
    assert [f.file for f in found] == ["or/badsig@ws1k"]
    assert found[0].rule == "ir-sig-parity" and found[0].severity == "P0"


# ------------------------------------------------------------ carry audit


def test_carry_audit_verifies_every_loop_at_head():
    audits = donation.all_carry_audits()
    assert [a.name for a in audits] == [
        "engine/run_from", "sharded/batch_from", "engine/coverage_from",
        "engine/converged_from", "engine/batch_from",
        "engine/batch_from_repad", "engine/query_from",
        "engine/query_from_rec", "engine/run_from_rec",
        "engine/coverage_from_rec", "engine/batch_from_rec"]
    assert donation.audit_carry(audits, device="cpu") == []


def _flood_loop(keep):
    """A flood loop of ``rounds`` steps that keeps carries as ``keep``
    says: "list" every round's, "two" the last two."""
    from p2pnetwork_tpu_torch.models.flood import Flood

    def build(device):
        g = registry.shape_class("ws1k", device)
        state = registry._resume_state(g)

        def run(rounds):
            proto, st, kept = Flood(source=0), state, []
            for _ in range(rounds):
                nxt, _ = proto.step(g, st, None)
                if keep == "list":
                    kept.append(nxt)
                else:
                    kept = [st, nxt]
                # A second, copied carry held through the next step.
                st = type(nxt)(seen=nxt.seen.clone(),
                               frontier=nxt.frontier.clone()) \
                    if keep == "two" else nxt
            return st, kept
        return run, state
    return build


def test_carry_kept_in_a_list_fires_retained():
    audit = donation.CarryAudit("engine/keeps-all", _flood_loop("list"))
    found = donation.audit_carry([audit], device="cpu")
    assert "ir-carry-retained" in [f.rule for f in found]
    assert all(f.file == "engine/keeps-all" for f in found)


def test_two_carries_held_fire_doubled():
    audit = donation.CarryAudit("engine/keeps-two", _flood_loop("two"))
    found = donation.audit_carry([audit], device="cpu")
    assert [f.rule for f in found] == ["ir-carry-doubled"]


def test_unrunnable_carry_program_is_a_finding():
    def build(device):
        raise OSError("no such loop")

    found = donation.audit_carry([donation.CarryAudit("x/y", build)],
                                 device="cpu")
    assert [f.rule for f in found] == ["ir-carry-unverifiable"]


# ------------------------------------------------------------ cost ratchet


@pytest.fixture(scope="module")
def head_costs(traces):
    return B.collect_costs(list(traces.values()))


def test_budgets_round_trip(head_costs, tmp_path):
    path = str(tmp_path / "budgets.json")
    B.write_budgets(head_costs, path)
    doc = B.load_budgets(path)
    assert doc["schema"] == B.SCHEMA and doc["torch"] == torch.__version__
    assert set(doc["entries"]) == set(head_costs)
    assert B.check_budgets(head_costs, doc) == []


def test_checked_in_budgets_match_head(head_costs):
    doc = B.load_budgets()
    assert doc, "analysis/ir/budgets.json is missing"
    assert doc["tolerance"] == B.DEFAULT_TOLERANCE
    assert B.check_budgets(head_costs, doc) == []


def test_inflated_cost_fails_the_ratchet(head_costs):
    doc = copy.deepcopy(B.load_budgets())
    name = "or/segment@ws1k"
    doc["entries"][name]["bytes"] = int(doc["entries"][name]["bytes"] / 1.5)
    doc["entries"]["or/frontier@ws1k"]["syncs"] -= 1
    found = {f.file: f for f in B.check_budgets(head_costs, doc)}
    assert found[name].rule == "ir-cost-ratchet" and \
        "grew 1.50x" in found[name].message
    assert "syncs changed" in found["or/frontier@ws1k"].message


def test_shrunk_cost_asks_for_a_re_bless(head_costs):
    doc = copy.deepcopy(B.load_budgets())
    name = "or/segment@ws1k"
    doc["entries"][name]["bytes"] *= 2
    found = [f for f in B.check_budgets(head_costs, doc) if f.file == name]
    assert found and found[0].severity == "P2"
    assert "shrank" in found[0].message


def test_kernel_and_exchange_drift_fail(head_costs):
    doc = copy.deepcopy(B.load_budgets())
    doc["entries"]["or/pallas@ws1k"]["kernels"]["segsum_or"] += 1
    doc["entries"]["cov/flood-ppermute@ws1k"]["exchanges"]["hops"] += 7
    messages = {f.file: f.message for f in B.check_budgets(head_costs, doc)}
    assert "kernels census changed" in messages["or/pallas@ws1k"]
    assert "exchanges census changed" in messages["cov/flood-ppermute@ws1k"]


def test_missing_and_stale_entries_are_findings(head_costs):
    doc = copy.deepcopy(B.load_budgets())
    doc["entries"]["or/ghost@ws1k"] = {"launches": 1, "bytes": 1}
    del doc["entries"]["or/segment@ws1k"]
    messages = {f.file: f.message for f in B.check_budgets(head_costs, doc)}
    assert "no blessed budget" in messages["or/segment@ws1k"]
    assert "no longer produces" in messages["or/ghost@ws1k"]


def test_blessed_error_record_is_a_finding_not_an_ungate(head_costs):
    doc = copy.deepcopy(B.load_budgets())
    doc["entries"]["or/segment@ws1k"] = {"error": "RuntimeError: boom"}
    found = [f for f in B.check_budgets(head_costs, doc)
             if f.file == "or/segment@ws1k"]
    assert found and "error record" in found[0].message


# ---------------------------------------------------------- memory ratchet


@pytest.fixture(scope="module")
def head_memory(traces):
    return M.collect_memory(list(traces.values()))


def test_checked_in_membudgets_match_head(head_memory):
    doc = M.load_membudgets()
    assert "capacity_model" in doc and doc["schema"] == M.SCHEMA
    assert set(doc["entries"]) == set(head_memory)
    assert M.check_membudgets(head_memory, doc) == []
    for rec in head_memory.values():
        assert rec["tracked"]["peak"] > 0


def test_inflated_peak_fails_and_drift_is_seen(head_memory):
    doc = copy.deepcopy(M.load_membudgets())
    doc["entries"]["or/segment@ws1k"]["tracked"]["peak"] //= 2
    recs = copy.deepcopy(head_memory)
    recs["sum/segment@ws1k"]["model_ratio"] = 1.5
    found = {(f.file, f.rule) for f in M.check_membudgets(recs, doc)}
    assert ("or/segment@ws1k", "ir-mem-regression") in found
    assert ("sum/segment@ws1k", "ir-mem-model-drift") in found


def test_write_membudgets_keeps_the_capacity_model(head_memory, tmp_path):
    path = tmp_path / "m.json"
    path.write_text(json.dumps({"capacity_model": {"schema": "x"}}))
    M.write_membudgets(head_memory, str(path))
    doc = M.load_membudgets(str(path))
    assert doc["capacity_model"] == {"schema": "x"}
    assert M.check_membudgets(head_memory, doc) == []


def test_analytic_walk_frees_at_last_use():
    # a -> b -> c, each 100 bytes; a dies when b is made from it.
    log = [("f", [(1, 100)], [(2, 100)]),
           ("g", [(2, 100)], [(3, 100)]),
           ("h", [(3, 100)], [(4, 100)])]
    got = M.analytic_memory(log, {4})
    assert got == {"peak": 200, "output": 100}


# --------------------------------------------------------------------- CLI


def test_cli_head_is_clean_with_json_document(capsys):
    from p2pnetwork_tpu_torch.analysis.ir.__main__ import main

    assert main(["--device", "cpu", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] is True and doc["findings"] == []
    assert doc["baselined"] == 1 and doc["device"] == "cpu"
    assert len(doc["lowerings"]) == 48
    assert "cov/flood-ppermute@ws1k" in doc["exchanges"]
    assert doc["costs"]["or/pallas@ws1k"]["kernels"] == {"segsum_or": 1}


def test_cli_no_cost_fast_pass(capsys):
    from p2pnetwork_tpu_torch.analysis.ir.__main__ import main

    assert main(["--device", "cpu", "--no-cost"]) == 0
    assert "clean" in capsys.readouterr().out


def test_cli_listings_and_bad_invocations(capsys):
    from p2pnetwork_tpu_torch.analysis.ir.__main__ import main

    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert "ir-host-sync" in out and "ir-carry-retained" in out
    assert main(["--list-lowerings"]) == 0
    assert "or/frontier@ws1k" in capsys.readouterr().out
    assert main(["--rules", "no-such-rule"]) == 2
    assert main(["--no-cost", "--write-budgets"]) == 2
    assert main(["--plan", "nodes=bad"]) == 2
    assert main(["--plan"]) == 0


def test_cli_without_device_asks_for_the_card(monkeypatch):
    from p2pnetwork_tpu_torch.analysis.ir.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(["--no-cost"])


def test_cli_write_budgets_round_trips(tmp_path, capsys):
    from p2pnetwork_tpu_torch.analysis.ir.__main__ import main

    path = str(tmp_path / "b.json")
    assert main(["--device", "cpu", "--no-mem", "--write-budgets",
                 "--budgets", path, "--tolerance", "0.35"]) == 0
    assert B.load_budgets(path)["tolerance"] == 0.35
    capsys.readouterr()
    assert main(["--device", "cpu", "--no-mem", "--budgets", path]) == 0


def test_cli_planted_fault_exits_one(monkeypatch, capsys):
    from p2pnetwork_tpu_torch.analysis.ir import __main__ as cli

    real = registry.all_lowerings

    def with_item():
        def build(device):
            return (lambda x: x * float(x.sum().item())), (_sig(),), None
        return real() + [_entry("sum/item@ws1k", build, parity=False)]

    monkeypatch.setattr(registry, "all_lowerings", with_item)
    assert cli.main(["--device", "cpu", "--no-cost"]) == 1
    out = capsys.readouterr().out
    assert "[ir-host-sync]" in out and "sum/item@ws1k" in out


# ----------------------------------------------- graftlint host-sync-in-loop


def _lint(src: str):
    return [f for f in core.analyze_source(textwrap.dedent(src),
                                           path="snippet.py")
            if f.rule == "host-sync-in-loop"]


@pytest.mark.parametrize("body", [
    "x.item()", "x.tolist()", "x.cpu()", "x.numpy()", "bool(x.any())",
    "int(x.sum())", "float(torch.max(x))"])
def test_host_sync_in_loop_fires(body):
    found = _lint(f"""\
        import torch

        def f(x):
            for _ in range(3):
                y = {body}
            while {body}:
                pass
        """)
    assert len(found) == 2 and all(f.severity == "P1" for f in found)


@pytest.mark.parametrize("src", [
    # no torch import: the rule reads torch modules only
    "def f(x):\n    for _ in range(3):\n        x.item()\n",
    # a for's iterable is read once
    "import torch\ndef f(x):\n    for v in x.tolist():\n        pass\n",
    # outside any loop
    "import torch\ndef f(x):\n    return x.item()\n",
    # int() of a plain name: no reduction in sight
    "import torch\ndef f(xs):\n    for x in xs:\n        int(x)\n",
    # suppressed with its reason
    "import torch\ndef f(x):\n    while True:\n        x.item()  "
    "# graftlint: ignore[host-sync-in-loop] -- the exit read\n",
])
def test_host_sync_in_loop_stays_quiet(src):
    assert _lint(src) == []
