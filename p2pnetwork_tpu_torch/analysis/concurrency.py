"""graftlint concurrency rules: lock discipline for the port's threaded
plane (the port's copy of the JAX package's ``analysis/concurrency.py``).

The threaded/async half of the port (the serving front end's driver and
callers, supervise's watchdog and store, node event loops, phi
monitoring threads, chaos driver threads, telemetry scrapers) carries lock-using
modules whose hazards only surface under chaos load — the wrong
interleaving of a blocking call under a held lock, or two locks taken in
opposite orders on two threads. These are *graph* properties of the code,
checkable statically:

The analysis builds, per module, a lock-acquisition model:

- **lock inventory** — ``self.x = threading.Lock()/RLock()/Condition()``
  assignments name class locks ``Class.x``; module-level assignments name
  module locks. ``with`` expressions that resolve to neither but *look*
  like locks (dotted text containing "lock"/"mutex"/"cond") become opaque
  locks: they participate in ordering but not in guard analysis.
- **regions** — ``with <lock>:`` blocks, nested, per function, including
  what is called, read, written, awaited and blocked-on inside each.
- **call edges** — ``self.method()`` and module-function calls resolve
  within the module; a bounded fixpoint propagates "locks this call may
  acquire" and "this call may block" through the edges, so a blocking
  call two frames below a ``with`` still indicts the ``with``.

Rules (see each docstring): ``lock-order-cycle`` (P0),
``lock-across-await`` (P0), ``blocking-under-lock`` (P1),
``async-blocking-call`` (P1), ``lock-guard`` (P2, inconsistent guard
discipline — the read that is safe today and a torn read after the next
refactor), ``lock-open-call`` (P2, calling out to foreign code while
holding a lock — the classic deadlock ingredient), ``wait-untimed`` (P2,
unbounded cross-thread waits).

Heuristics are deliberately conservative-but-syntactic; the suppression
and baseline machinery (core.py) absorbs judged-acceptable sites, each
with its rationale in the comment.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from p2pnetwork_tpu_torch.analysis.core import Module, register_rule
from p2pnetwork_tpu_torch.analysis.torchrules import dotted_name, resolve_dotted

#: The concurrency seams whose factories build primitives: the port's
#: own (p2pnetwork_tpu_torch/concurrency.py) and the JAX package's, which
#: has the same API, so the linter reads either tree alike.
_SEAMS = ("p2pnetwork_tpu_torch.concurrency", "p2pnetwork_tpu.concurrency")

_LOCK_FACTORIES = {
    "threading.Lock": "Lock",
    "threading.RLock": "RLock",
    "threading.Condition": "Condition",
    # The seam's factories: production code constructs locks through
    # these, and the inventory must keep recognizing them or every
    # guard/ordering rule silently degrades to the "lockish word"
    # heuristic.
    **{f"{seam}.{fn}": kind for seam in _SEAMS
       for fn, kind in (("lock", "Lock"), ("rlock", "RLock"),
                        ("condition", "Condition"))},
}
_SEAM_SLEEPS = frozenset(f"{seam}.sleep" for seam in _SEAMS)
_LOCKISH_WORDS = ("lock", "mutex", "cond")

#: Attribute methods that mutate a container in place — used both to
#: classify guarded-state writes and to exempt them from lock-open-call.
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "insert", "add", "update", "pop",
    "popleft", "popitem", "remove", "discard", "clear", "setdefault",
    "difference_update", "intersection_update", "symmetric_difference_update",
    "sort", "reverse", "record",
})
_SAFE_ATTR_CALLS = _MUTATORS | frozenset({
    "get", "items", "keys", "values", "copy", "count", "index", "union",
    "difference", "intersection", "issubset", "issuperset", "most_common",
    "split", "rsplit", "strip", "lstrip", "rstrip", "startswith", "endswith",
    "encode", "decode", "format", "lower", "upper", "replace", "partition",
    "rpartition", "hexdigest", "digest", "labels", "snapshot",
})
_SAFE_BUILTINS = frozenset({
    "len", "list", "dict", "set", "tuple", "frozenset", "str", "int",
    "float", "bool", "bytes", "sorted", "reversed", "min", "max", "sum",
    "abs", "round", "any", "all", "zip", "enumerate", "range", "map",
    "filter", "isinstance", "issubclass", "getattr", "hasattr", "setattr",
    "repr", "format", "id", "hash", "iter", "next", "type", "vars",
    "super", "ValueError", "TypeError", "KeyError", "RuntimeError",
})
_SOCKET_BLOCKING_ATTRS = frozenset({"recv", "recvfrom", "recv_into",
                                    "sendall", "accept"})
_SUBPROCESS_BLOCKING = frozenset({"subprocess.run", "subprocess.call",
                                  "subprocess.check_call",
                                  "subprocess.check_output"})


def _blocking_desc(module: Module, call: ast.Call) -> Optional[str]:
    """A human-readable description if ``call`` is a known blocking op."""
    fn = call.func
    resolved = resolve_dotted(module, fn)
    if resolved == "time.sleep":
        return "time.sleep()"
    if resolved in _SEAM_SLEEPS:
        # The seam's sleep is time.sleep in production (a scheduling
        # point only under graftrace) — same blocking verdict.
        return "concurrency.sleep()"
    if resolved in _SUBPROCESS_BLOCKING:
        return f"{resolved}()"
    if resolved is not None and resolved.startswith("requests."):
        return f"{resolved}() (network I/O)"
    if isinstance(fn, ast.Name) and fn.id == "input":
        return "input()"
    if not isinstance(fn, ast.Attribute):
        return None
    untimed = not call.args and not call.keywords
    if fn.attr in _SOCKET_BLOCKING_ATTRS:
        return f"socket .{fn.attr}()"
    if fn.attr == "wait" and untimed:
        return "untimed .wait()"
    if fn.attr == "result" and untimed:
        return "untimed .result()"
    if fn.attr == "join" and untimed:
        return "untimed .join()"
    if fn.attr in ("get", "put"):
        receiver = (dotted_name(fn.value) or "").lower()
        if "queue" in receiver and not any(
                kw.arg in ("timeout", "block") for kw in call.keywords):
            return f"untimed queue .{fn.attr}()"
    return None


# -------------------------------------------------------------- summaries


@dataclasses.dataclass
class _Summary:
    key: str
    name: str
    class_name: Optional[str]
    node: ast.AST
    is_async: bool
    # (lock id, with-node) for every direct acquisition.
    acquires: List[Tuple[str, ast.AST]] = dataclasses.field(
        default_factory=list)
    # Syntactic nesting: (outer lock, inner lock) -> sample site.
    nest_edges: Dict[Tuple[str, str], ast.AST] = dataclasses.field(
        default_factory=dict)
    # Every resolvable call: (held locks, site, callee key, in await).
    calls: List[Tuple[FrozenSet[str], ast.AST, str, bool]] = \
        dataclasses.field(default_factory=list)
    # Unresolvable calls made while ≥1 lock is held.
    opaque_under: List[Tuple[FrozenSet[str], ast.AST, str]] = \
        dataclasses.field(default_factory=list)
    # Known-blocking ops: (held locks, site, description, in await).
    blocking: List[Tuple[FrozenSet[str], ast.AST, str, bool]] = \
        dataclasses.field(default_factory=list)
    awaits_under: List[Tuple[FrozenSet[str], ast.AST]] = dataclasses.field(
        default_factory=list)
    # self-attribute traffic: (attr, site, held locks, is mutation).
    attr_access: List[Tuple[str, ast.AST, FrozenSet[str], bool]] = \
        dataclasses.field(default_factory=list)
    # module-global traffic: (name, site, held locks, is mutation).
    global_access: List[Tuple[str, ast.AST, FrozenSet[str], bool]] = \
        dataclasses.field(default_factory=list)
    # Fixpoint results.
    acquires_closure: Set[str] = dataclasses.field(default_factory=set)
    may_block: Optional[str] = None


class _ModuleConcurrency:
    """One module's lock model: inventory, per-function summaries, edges."""

    def __init__(self, module: Module):
        self.module = module
        self.class_locks: Dict[str, Dict[str, str]] = {}   # class -> attr -> kind
        self.module_locks: Dict[str, str] = {}             # name -> kind
        self.lock_kinds: Dict[str, str] = {}               # lock id -> kind
        self.summaries: Dict[str, _Summary] = {}
        self.module_globals: Set[str] = set()
        self._collect_inventory()
        self._collect_summaries()
        self._fixpoint()

    # ---------------------------------------------------------- inventory

    def _lock_kind(self, value: ast.AST) -> Optional[str]:
        if isinstance(value, ast.Call):
            return _LOCK_FACTORIES.get(
                resolve_dotted(self.module, value.func) or "")
        return None

    def _collect_inventory(self) -> None:
        tree = self.module.tree
        for stmt in tree.body:
            if isinstance(stmt, ast.Assign):
                kind = self._lock_kind(stmt.value)
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name):
                        self.module_globals.add(tgt.id)
                        if kind:
                            self.module_locks[tgt.id] = kind
                            self.lock_kinds[tgt.id] = kind
        for cls in ast.walk(tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            locks: Dict[str, str] = {}
            for node in ast.walk(cls):
                if isinstance(node, ast.Assign):
                    kind = self._lock_kind(node.value)
                    if not kind:
                        continue
                    for tgt in node.targets:
                        if (isinstance(tgt, ast.Attribute)
                                and isinstance(tgt.value, ast.Name)
                                and tgt.value.id == "self"):
                            locks[tgt.attr] = kind
                            self.lock_kinds[f"{cls.name}.{tgt.attr}"] = kind
            if locks:
                self.class_locks[cls.name] = locks

    def _resolve_lock(self, expr: ast.AST,
                      class_name: Optional[str]) -> Optional[str]:
        """Lock id for a with-expression, or None if it isn't lock-like.
        ``self.x`` resolves against the enclosing class's inventory; a
        bare name against module locks; anything whose dotted text smells
        like a lock becomes an opaque lock id."""
        dotted = dotted_name(expr)
        if dotted is None:
            return None
        if dotted in self.module_locks:
            return dotted
        if (class_name and dotted.startswith("self.")
                and dotted[5:] in self.class_locks.get(class_name, {})):
            return f"{class_name}.{dotted[5:]}"
        low = dotted.lower()
        if any(w in low for w in _LOCKISH_WORDS):
            self.lock_kinds.setdefault(dotted, "opaque")
            return dotted
        return None

    # ---------------------------------------------------------- summaries

    def _collect_summaries(self) -> None:
        tree = self.module.tree
        targets: List[Tuple[ast.AST, Optional[str], str]] = []
        for stmt in tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                targets.append((stmt, None, ""))
            elif isinstance(stmt, ast.ClassDef):
                for sub in stmt.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        targets.append((sub, stmt.name, f"{stmt.name}."))
        # Keys are pre-registered so a method can resolve calls to methods
        # defined after it (summaries fill in as each body is walked).
        self.function_keys: Set[str] = {
            prefix + fn.name for fn, _, prefix in targets}
        for fn, class_name, prefix in targets:
            self._summarize(fn, class_name=class_name, prefix=prefix)

    def _summarize(self, fn, class_name: Optional[str], prefix: str) -> None:
        key = prefix + fn.name
        summary = _Summary(
            key=key, name=fn.name, class_name=class_name, node=fn,
            is_async=isinstance(fn, ast.AsyncFunctionDef))
        self.summaries[key] = summary
        declared_globals: Set[str] = set()
        # Locals whose value derives from a self attribute — method calls
        # on them under a lock are treated as touching that guarded state,
        # not as calling out to foreign code.
        derived: Dict[str, str] = {}
        local_defs: Dict[str, ast.AST] = {}

        def root_attr(expr: ast.AST) -> Optional[str]:
            """The self-attribute (or derived local's attribute) a value
            expression is rooted at, if any."""
            node = expr
            while True:
                if isinstance(node, ast.Call):
                    node = node.func
                elif isinstance(node, ast.Attribute):
                    if (isinstance(node.value, ast.Name)
                            and node.value.id == "self"):
                        return node.attr
                    node = node.value
                elif isinstance(node, ast.Subscript):
                    node = node.value
                elif isinstance(node, ast.Name):
                    return derived.get(node.id)
                else:
                    return None

        def record_attr(attr: str, site: ast.AST, held: FrozenSet[str],
                        mutation: bool) -> None:
            summary.attr_access.append((attr, site, held, mutation))

        def visit(node: ast.AST, held: Tuple[str, ...],
                  in_await: bool) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node is not fn:
                    # Nested defs execute later, not under these locks;
                    # summarize independently and resolve calls by name.
                    local_defs[node.name] = node
                    self._summarize(node, class_name, prefix=key + ".")
                    return
                for child in ast.iter_child_nodes(node):
                    visit(child, held, in_await)
                return
            if isinstance(node, ast.Lambda):
                return  # a value, not an execution under these locks
            if isinstance(node, ast.Global):
                declared_globals.update(node.names)
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                acquired: List[str] = []
                for item in node.items:
                    lock = self._resolve_lock(item.context_expr, class_name)
                    if lock is not None:
                        summary.acquires.append((lock, node))
                        for outer in held:
                            summary.nest_edges.setdefault((outer, lock),
                                                          node)
                        acquired.append(lock)
                    else:
                        visit(item.context_expr, held, in_await)
                    if item.optional_vars is not None:
                        visit(item.optional_vars, held, in_await)
                inner = held + tuple(acquired)
                for child in node.body:
                    visit(child, inner, in_await)
                return
            if isinstance(node, ast.Await):
                if held:
                    summary.awaits_under.append((frozenset(held), node))
                visit(node.value, held, True)
                return
            if isinstance(node, ast.Assign):
                rooted = root_attr(node.value)
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        if rooted is not None:
                            derived[tgt.id] = rooted
                        if tgt.id in declared_globals:
                            summary.global_access.append(
                                (tgt.id, node, frozenset(held), True))
                visit(node.value, held, in_await)
                for tgt in node.targets:
                    visit(tgt, held, in_await)
                return
            if isinstance(node, ast.Call):
                self._record_call(summary, node, held, in_await,
                                  class_name, derived, local_defs, key,
                                  record_attr)
                for child in ast.iter_child_nodes(node):
                    visit(child, held, in_await)
                return
            if isinstance(node, ast.Attribute):
                if isinstance(node.value, ast.Name) and \
                        node.value.id == "self":
                    mutation = isinstance(node.ctx, (ast.Store, ast.Del))
                    record_attr(node.attr, node, frozenset(held), mutation)
                visit(node.value, held, in_await)
                return
            if isinstance(node, ast.Subscript):
                # self.x[...] = v mutates the container behind self.x.
                rooted = root_attr(node.value)
                if rooted is not None and isinstance(node.ctx,
                                                     (ast.Store, ast.Del)):
                    record_attr(rooted, node, frozenset(held), True)
                for child in ast.iter_child_nodes(node):
                    visit(child, held, in_await)
                return
            if isinstance(node, ast.Name):
                if (node.id in self.module_globals
                        and node.id not in self.module_locks):
                    mutation = (isinstance(node.ctx, (ast.Store, ast.Del))
                                and node.id in declared_globals)
                    if mutation or isinstance(node.ctx, ast.Load):
                        summary.global_access.append(
                            (node.id, node, frozenset(held), mutation))
                return
            for child in ast.iter_child_nodes(node):
                visit(child, held, in_await)

        visit(fn, (), False)

    def _record_call(self, summary: _Summary, call: ast.Call,
                     held: Tuple[str, ...], in_await: bool,
                     class_name: Optional[str], derived: Dict[str, str],
                     local_defs: Dict[str, ast.AST], key: str,
                     record_attr) -> None:
        held_fs = frozenset(held)
        fn = call.func
        desc = _blocking_desc(self.module, call)
        if desc is not None:
            summary.blocking.append((held_fs, call, desc, in_await))
            return
        # Resolvable callees: self.method, module function, nested def.
        if (isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Name) and fn.value.id == "self"
                and class_name is not None
                and f"{class_name}.{fn.attr}" in self.function_keys):
            summary.calls.append(
                (held_fs, call, f"{class_name}.{fn.attr}", in_await))
            return
        if isinstance(fn, ast.Name):
            if fn.id in local_defs:
                summary.calls.append((held_fs, call, f"{key}.{fn.id}",
                                      in_await))
                return
            if fn.id in self.function_keys:
                summary.calls.append((held_fs, call, fn.id, in_await))
                return
            if fn.id in self._module_classes():
                # Local class construction: follow __init__ when defined
                # (a missing __init__ is object's — trivially safe).
                init = f"{fn.id}.__init__"
                if init in self.function_keys:
                    summary.calls.append((held_fs, call, init, in_await))
                return
            if fn.id in _SAFE_BUILTINS:
                return
        if not held:
            return
        # Under a lock and unresolvable: either touching guarded state
        # (fine) or calling out to foreign code (the open-call hazard).
        if isinstance(fn, ast.Attribute):
            if fn.attr in _SAFE_ATTR_CALLS:
                root = self._receiver_root(fn.value, derived)
                if root is not None:
                    if root != "<foreign>":
                        record_attr(root, call, held_fs,
                                    fn.attr in _MUTATORS)
                    return
                return  # container-style call on a local value
            root = self._receiver_root(fn.value, derived)
            if root is not None and root != "<foreign>":
                # Method call on guarded/derived self state with a
                # non-container method name: still a call out of our
                # control only if the receiver is a foreign object; a
                # self-attribute holding plain data gets the benefit of
                # the doubt only for container methods above, so flag it.
                # Name the receiver the code actually calls: for a
                # derived local (`mine = self._crdts.get(..)`), claiming
                # `self._crdts.merge()` would point at a method the
                # container doesn't have.
                if isinstance(fn.value, ast.Name) and fn.value.id in derived:
                    label = (f"{fn.value.id}.{fn.attr}() (on `{fn.value.id}`,"
                             f" derived from self.{root})")
                else:
                    label = f"self.{root}.{fn.attr}()"
                summary.opaque_under.append((held_fs, call, label))
                return
            summary.opaque_under.append(
                (held_fs, call, f"{dotted_name(fn) or fn.attr}()"))
            return
        label = dotted_name(fn) or getattr(fn, "id", None) or "<expr>"
        summary.opaque_under.append((held_fs, call, f"{label}()"))

    def _receiver_root(self, expr: ast.AST,
                       derived: Dict[str, str]) -> Optional[str]:
        """self-attribute name a receiver is rooted at; ``None`` for plain
        locals/literals; ``"<foreign>"`` for anything rooted elsewhere."""
        node = expr
        while True:
            if isinstance(node, ast.Attribute):
                if isinstance(node.value, ast.Name) and \
                        node.value.id == "self":
                    return node.attr
                node = node.value
            elif isinstance(node, ast.Subscript):
                node = node.value
            elif isinstance(node, ast.Call):
                node = node.func
            elif isinstance(node, ast.Name):
                root = derived.get(node.id)
                return root  # a derived local maps home; else plain local
            else:
                return None

    def _module_classes(self) -> Set[str]:
        return set(self.class_locks) | {
            n.name for n in self.module.tree.body
            if isinstance(n, ast.ClassDef)}

    # ----------------------------------------------------------- fixpoint

    def _fixpoint(self) -> None:
        for s in self.summaries.values():
            s.acquires_closure = {lock for lock, _ in s.acquires}
            direct = [d for _, _, d, _ in s.blocking]
            s.may_block = direct[0] if direct else None
        for _ in range(12):
            changed = False
            for s in self.summaries.values():
                for _, _, callee_key, _ in s.calls:
                    callee = self.summaries.get(callee_key)
                    if callee is None:
                        continue
                    before = len(s.acquires_closure)
                    s.acquires_closure |= callee.acquires_closure
                    if len(s.acquires_closure) != before:
                        changed = True
                    if s.may_block is None and callee.may_block is not None:
                        s.may_block = (f"{callee.name}() -> "
                                       f"{callee.may_block}")
                        changed = True
            if not changed:
                break

    # -------------------------------------------------------------- edges

    def lock_edges(self) -> Dict[Tuple[str, str], Tuple[ast.AST, str]]:
        """(outer, inner) -> (site, via) for every ordered pair where
        ``inner`` may be acquired while ``outer`` is held — syntactic
        nesting plus call-closure edges."""
        edges: Dict[Tuple[str, str], Tuple[ast.AST, str]] = {}
        for s in self.summaries.values():
            for pair, site in s.nest_edges.items():
                edges.setdefault(pair, (site, s.key))
            for held, site, callee_key, _ in s.calls:
                callee = self.summaries.get(callee_key)
                if callee is None or not held:
                    continue
                for inner in callee.acquires_closure:
                    for outer in held:
                        edges.setdefault(
                            (outer, inner),
                            (site, f"{s.key} -> {callee_key}"))
        return edges


def _concurrency(module: Module) -> _ModuleConcurrency:
    cached = getattr(module, "_graftlint_concurrency", None)
    if cached is None:
        cached = _ModuleConcurrency(module)
        module._graftlint_concurrency = cached
    return cached


def _fmt_locks(locks: Iterable[str]) -> str:
    return "/".join(sorted(locks))


# ------------------------------------------------------------------ rules


@register_rule(
    "lock-order-cycle", "P0",
    "Two (or more) locks are acquired in conflicting orders — or a "
    "non-reentrant lock is re-acquired while held. The wrong two threads "
    "deadlock forever.")
def rule_lock_order_cycle(module: Module) -> Iterable[Tuple[ast.AST, str]]:
    conc = _concurrency(module)
    edges = conc.lock_edges()
    # Self-deadlock: re-acquiring a plain Lock (RLock/Condition re-enter).
    for (outer, inner), (site, via) in sorted(edges.items()):
        if outer == inner and conc.lock_kinds.get(outer) == "Lock":
            yield site, (f"non-reentrant lock `{outer}` may be re-acquired "
                         f"while already held (via {via}) — guaranteed "
                         "self-deadlock on that path")
    # Order cycles across distinct locks.
    graph: Dict[str, Set[str]] = {}
    for (outer, inner) in edges:
        if outer != inner:
            graph.setdefault(outer, set()).add(inner)
    reported: Set[FrozenSet[str]] = set()
    for start in sorted(graph):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in sorted(graph.get(node, ())):
                if nxt == start and len(path) > 1:
                    cycle = frozenset(path)
                    if cycle in reported:
                        continue
                    reported.add(cycle)
                    site, via = edges[(path[-1], start)]
                    chain = " -> ".join(path + [start])
                    yield site, (f"lock-order cycle {chain} (edge via "
                                 f"{via}) — two threads entering from "
                                 "different ends deadlock")
                elif nxt not in path:
                    stack.append((nxt, path + [nxt]))


@register_rule(
    "lock-across-await", "P0",
    "A threading lock is held across an `await`: the coroutine parks with "
    "the lock held, and any thread contending for it blocks the whole "
    "event loop with it.")
def rule_lock_across_await(module: Module) -> Iterable[Tuple[ast.AST, str]]:
    conc = _concurrency(module)
    for s in conc.summaries.values():
        for held, site in s.awaits_under:
            yield site, (f"`await` while holding {_fmt_locks(held)} — "
                         "release before suspending (copy what you need "
                         "under the lock, await after), or use an asyncio "
                         "lock confined to the loop")


@register_rule(
    "blocking-under-lock", "P1",
    "A known-blocking call (sleep, socket op, untimed wait/result/join, "
    "untimed queue get/put, subprocess) runs while a lock is held — every "
    "other thread needing that lock stalls for the duration.")
def rule_blocking_under_lock(module: Module) -> Iterable[Tuple[ast.AST, str]]:
    conc = _concurrency(module)
    for s in conc.summaries.values():
        for held, site, desc, _ in s.blocking:
            if held:
                yield site, (f"{desc} while holding {_fmt_locks(held)} — "
                             "move the blocking work outside the critical "
                             "section")
        for held, site, callee_key, _ in s.calls:
            callee = conc.summaries.get(callee_key)
            if held and callee is not None and callee.may_block:
                yield site, (f"call to {callee.name}() while holding "
                             f"{_fmt_locks(held)} may block "
                             f"({callee.may_block}) — move it outside the "
                             "critical section")


@register_rule(
    "async-blocking-call", "P1",
    "A blocking call inside `async def` (not awaited): it stalls the "
    "whole event loop — every connection this node serves.")
def rule_async_blocking(module: Module) -> Iterable[Tuple[ast.AST, str]]:
    conc = _concurrency(module)
    for s in conc.summaries.values():
        if not s.is_async:
            continue
        for _, site, desc, in_await in s.blocking:
            if in_await:
                continue  # `await x.wait()` — the asyncio form, fine
            yield site, (f"{desc} inside `async def {s.name}` — use the "
                         "asyncio equivalent (asyncio.sleep, run_in_"
                         "executor, wait_for) or move it off the loop")
        for _, site, callee_key, in_await in s.calls:
            callee = conc.summaries.get(callee_key)
            if (not in_await and callee is not None and callee.may_block
                    and not callee.is_async):
                yield site, (f"call to {callee.name}() inside `async def "
                             f"{s.name}` may block the event loop "
                             f"({callee.may_block})")


@register_rule(
    "lock-guard", "P2",
    "State is written under a lock in one place and touched without it in "
    "another: the unguarded access is a torn read/write waiting for the "
    "next refactor (or the next chaos run) to expose it.")
def rule_lock_guard(module: Module) -> Iterable[Tuple[ast.AST, str]]:
    conc = _concurrency(module)
    # ---- class attributes -------------------------------------------
    by_class: Dict[str, List[Tuple[str, ast.AST, FrozenSet[str], bool, str]]]
    by_class = {}
    for s in conc.summaries.values():
        if s.class_name is None or s.class_name not in conc.class_locks:
            continue
        skip = s.name in ("__init__", "__new__", "__del__") or \
            s.name.endswith("_locked")
        if skip:
            continue
        for attr, site, held, mutation in s.attr_access:
            by_class.setdefault(s.class_name, []).append(
                (attr, site, held, mutation, s.name))
    for cls, accesses in sorted(by_class.items()):
        inventory = {f"{cls}.{a}" for a in conc.class_locks[cls]}
        lock_attrs = set(conc.class_locks[cls])
        guards: Dict[str, Set[str]] = {}
        for attr, _, held, mutation, _ in accesses:
            if mutation and attr not in lock_attrs:
                locks = set(held) & inventory
                if locks:
                    guards.setdefault(attr, set()).update(locks)
        for attr, site, held, mutation, fn_name in accesses:
            guard = guards.get(attr)
            if not guard or set(held) & guard:
                continue
            verb = "written" if mutation else "read"
            yield site, (f"self.{attr} is {verb} in {fn_name}() without "
                         f"{_fmt_locks(guard)}, which guards its writes "
                         "elsewhere — take the lock (or document the race "
                         "with a suppression)")
    # ---- module globals ---------------------------------------------
    guards_g: Dict[str, Set[str]] = {}
    for s in conc.summaries.values():
        for name, _, held, mutation in s.global_access:
            if mutation:
                locks = set(held) & set(conc.module_locks)
                if locks:
                    guards_g.setdefault(name, set()).update(locks)
    for s in conc.summaries.values():
        for name, site, held, mutation in s.global_access:
            guard = guards_g.get(name)
            if not guard or set(held) & guard:
                continue
            verb = "written" if mutation else "read"
            yield site, (f"module global `{name}` is {verb} in "
                         f"{s.name}() without {_fmt_locks(guard)}, which "
                         "guards its writes elsewhere — take the lock")


@register_rule(
    "lock-open-call", "P2",
    "A call to foreign code (another object's method, an imported "
    "function) while holding a lock: if the callee ever blocks or takes "
    "its own lock, the hold time — and the deadlock surface — is no "
    "longer yours to reason about. Prefer open calls: copy state under "
    "the lock, call outside it.")
def rule_lock_open_call(module: Module) -> Iterable[Tuple[ast.AST, str]]:
    conc = _concurrency(module)
    for s in conc.summaries.values():
        for held, site, desc in s.opaque_under:
            yield site, (f"{desc} called while holding {_fmt_locks(held)} "
                         "— an open-call discipline keeps foreign code "
                         "outside critical sections; copy under the lock, "
                         "call after release")


#: Constructions the concurrency seam (p2pnetwork_tpu_torch/concurrency.py)
#: owns: building one of these directly bypasses the seam, so graftrace
#: can neither schedule nor observe it. ``threading.local`` is absent
#: deliberately (thread-local storage is not a synchronization
#: primitive), as is ``threading.current_thread`` (a query, not a
#: construction).
_RAW_PRIMITIVES = frozenset({
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Event", "threading.Thread", "threading.Semaphore",
    "threading.BoundedSemaphore", "threading.Barrier", "threading.Timer",
    "queue.Queue", "queue.LifoQueue", "queue.PriorityQueue",
    "queue.SimpleQueue", "time.sleep",
})

_SEAM_EQUIVALENT = {
    "threading.Lock": "concurrency.lock()",
    "threading.RLock": "concurrency.rlock()",
    "threading.Condition": "concurrency.condition()",
    "threading.Event": "concurrency.event()",
    "threading.Thread": "concurrency.thread(...)",
    "queue.Queue": "concurrency.fifo_queue()",
    "time.sleep": "concurrency.sleep()",
}


@register_rule(
    "raw-concurrency-primitive", "P2",
    "A threading/queue primitive (or time.sleep) is constructed directly "
    "instead of through the p2pnetwork_tpu_torch.concurrency seam: graftrace "
    "cannot schedule or observe it, so the deterministic-concurrency "
    "gate silently loses coverage of whatever it guards.")
def rule_raw_concurrency_primitive(module: Module
                                   ) -> Iterable[Tuple[ast.AST, str]]:
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        resolved = resolve_dotted(module, node.func)
        if resolved not in _RAW_PRIMITIVES:
            continue
        hint = _SEAM_EQUIVALENT.get(
            resolved, "a p2pnetwork_tpu_torch.concurrency factory")
        yield node, (f"direct {resolved}(...) bypasses the concurrency "
                     f"seam — use {hint} so graftrace can instrument it "
                     "(or suppress with the rationale that this one must "
                     "stay raw)")


@register_rule(
    "wait-untimed", "P2",
    "An unbounded cross-thread wait (.wait()/.result()/.join() with no "
    "timeout): if the other side is wedged, the caller hangs forever — "
    "bound it and surface the timeout as a structured error.")
def rule_wait_untimed(module: Module) -> Iterable[Tuple[ast.AST, str]]:
    conc = _concurrency(module)
    for s in conc.summaries.values():
        if s.is_async:
            continue  # the async variants are async-blocking-call's beat
        for held, site, desc, in_await in s.blocking:
            if held or in_await or not desc.startswith("untimed ."):
                continue
            yield site, (f"{desc.replace('untimed ', '')} with no timeout "
                         "— a wedged counterpart hangs this thread "
                         "forever; pass a bound and handle the timeout")
