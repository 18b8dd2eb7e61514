"""graftlint's backend-neutral rule and the AST helpers the lock rules
share: the port's counterpart of the JAX package's ``analysis/jaxrules.py``.

========================  =====  ==============================================
rule                      sev    fires on
========================  =====  ==============================================
``unbounded-cache``       P2     a module/class-level dict cache written
                                 inside a function with no eviction anywhere
                                 in the module — every distinct key resident
                                 forever
``host-sync-in-loop``     P1     ``.item()``, ``.tolist()``, ``.cpu()``,
                                 ``.numpy()``, or ``bool()``/``int()``/
                                 ``float()`` of a reduction, inside the body
                                 of a ``for``/``while`` of a module that
                                 imports torch — a device->host sync a
                                 round
========================  =====  ==============================================

The JAX rules have no counterpart here, because the port runs eager
torch and compiles nothing:

- ``jit-in-loop``, ``jit-immediate-call``, ``jit-static-array`` and
  ``jit-closure-ndarray`` police ``jax.jit`` construction and its cache
  keys; the port builds no traced program, so there is no cache to miss.
- ``tracer-branch`` flags Python branches on traced values; eager
  tensors are concrete, and a branch on one is a host sync, not a
  retrace.
- ``f64-literal`` guards against JAX's x64-off silent downcast; torch
  keeps ``float64`` as written.
- ``carry-no-donate`` asks ``lax`` loops to donate their carry; the
  port's loops update tensors in place, with no donation to ask for.

``host-sync-in-loop`` is the reference's rule in torch's terms. It
cannot see types, so it flags the four reading methods on anything, and
``bool()``/``int()``/``float()`` only of a reduction call (``.sum()``,
``.any()``, ``.max()``... or a ``torch.*`` call), where the argument is
a tensor in all but name. A ``for`` loop's iterable is evaluated once, so
only a loop's body (and a ``while``'s test) is searched. A read the loop
needs (an exit flag, counted in ``_device.SYNCS``) or a read of host
numpy is suppressed on its line with the reason.

Stdlib only: no torch import, like the rest of the linter.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from p2pnetwork_tpu_torch.analysis.core import Module, register_rule

__all__ = ["dotted_name", "resolve_dotted"]

#: Methods that read a tensor's values on the host.
SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
#: Reductions whose ``bool()``/``int()``/``float()`` is a host read.
_REDUCTIONS = frozenset({
    "sum", "any", "all", "max", "min", "amax", "amin", "mean", "prod",
    "count_nonzero", "argmax", "argmin", "norm", "item"})


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def resolve_dotted(module: Module, node: ast.AST) -> Optional[str]:
    """Canonical dotted path of a Name/Attribute, import aliases expanded:
    with ``import numpy as np``, ``np.float64`` -> ``numpy.float64``;
    with ``from threading import Event``, ``Event`` ->
    ``threading.Event``."""
    dotted = dotted_name(node)
    if dotted is None:
        return None
    head, _, rest = dotted.partition(".")
    if head in module.from_imports:
        head = module.from_imports[head]
    elif head in module.aliases:
        # ``import numpy as np`` -> np resolves to numpy. A bare
        # ``import torch.nn`` binds "torch", which aliases map correctly.
        target = module.aliases[head]
        if head != target:
            head = target
    return f"{head}.{rest}" if rest else head


@register_rule(
    "unbounded-cache", "P2",
    "A module/class-level dict cache written inside a function with no "
    "eviction anywhere in the module: every distinct key stays resident "
    "for the process lifetime — memoization that looks free until the "
    "key space turns out to be user-shaped.")
def rule_unbounded_cache(module: Module) -> Iterable[Tuple[ast.AST, str]]:
    # The pattern: `_CACHE: dict = {}` at module (or
    # class) scope, `_CACHE[key] = build(...)` inside a function, nothing
    # anywhere that ever removes an entry. Deliberately bounded caches
    # (finite key vocabulary) suppress with the rationale on the
    # DECLARATION line — that is where the finding anchors.

    def _empty_dict(value: Optional[ast.AST]) -> bool:
        if isinstance(value, ast.Dict) and not value.keys:
            return True
        return (isinstance(value, ast.Call)
                and isinstance(value.func, ast.Name)
                and value.func.id == "dict"
                and not value.args and not value.keywords)

    def _decl_of(body: Sequence[ast.stmt]) -> Iterable[Tuple[str, ast.AST]]:
        for stmt in body:
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and _empty_dict(stmt.value)):
                yield stmt.targets[0].id, stmt
            elif (isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)
                    and _empty_dict(stmt.value)):
                yield stmt.target.id, stmt

    caches: Dict[str, ast.AST] = dict(_decl_of(module.tree.body))
    for cls in ast.walk(module.tree):
        if isinstance(cls, ast.ClassDef):
            # A class-body dict is ONE shared mapping per class —
            # self._cache[k] = v from any instance grows it globally.
            caches.update(_decl_of(cls.body))
    if not caches:
        return

    def _base(expr: ast.AST) -> Optional[str]:
        """The cache a subscript/method target names: bare ``NAME`` or
        the shared class dict through ``self``/``cls``."""
        if isinstance(expr, ast.Name):
            return expr.id
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id in ("self", "cls")):
            return expr.attr
        return None

    evicted: Set[str] = set()
    writes: Dict[str, Tuple[str, int]] = {}  # cache -> (fn, write count)
    for fn in ast.walk(module.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Delete):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Subscript):
                        name = _base(tgt.value)
                        if name in caches:
                            evicted.add(name)
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute):
                name = _base(node.func.value)
                if name in caches:
                    if node.func.attr in ("pop", "popitem", "clear"):
                        evicted.add(name)
                    elif node.func.attr == "setdefault" \
                            and len(node.args) >= 2:
                        had = writes.get(name, (fn.name, 0))
                        writes[name] = (had[0], had[1] + 1)
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for tgt in targets:
                    if isinstance(tgt, ast.Subscript):
                        name = _base(tgt.value)
                        if name in caches:
                            had = writes.get(name, (fn.name, 0))
                            writes[name] = (had[0], had[1] + 1)
                    elif isinstance(tgt, ast.Name) and tgt.id in caches:
                        # A function-scope rebind (`CACHE = {}`) resets
                        # the mapping — eviction by replacement.
                        evicted.add(tgt.id)

    for name, (fn_name, count) in sorted(writes.items()):
        if name in evicted:
            continue
        more = f" (and {count - 1} more site(s))" if count > 1 else ""
        yield caches[name], (
            f"dict cache `{name}` grows inside `{fn_name}`{more} with no "
            "eviction anywhere in the module — bound it (maxsize + "
            "pop/clear, or functools.lru_cache) or suppress here with "
            "the rationale for why its key space is finite")


def _loop_parts(loop: ast.AST) -> List[ast.AST]:
    """What a loop runs each iteration: its body and ``else`` (and a
    ``while``'s test); a ``for``'s iterable is evaluated once."""
    parts: List[ast.AST] = list(loop.body) + list(loop.orelse)
    if isinstance(loop, ast.While):
        parts.append(loop.test)
    return parts


def _reduction_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and (node.func.attr in _REDUCTIONS
                 or (isinstance(node.func.value, ast.Name)
                     and node.func.value.id == "torch")))


@register_rule(
    "host-sync-in-loop", "P1",
    "Host-synchronizing read inside a loop of a torch module: each "
    "iteration blocks on a device->host transfer, serializing the loop "
    "with the card.")
def rule_host_sync_in_loop(module: Module) -> Iterable[Tuple[ast.AST, str]]:
    if not module.imports_package("torch"):
        return
    seen: Set[int] = set()  # a call nested in N loops is still ONE finding
    for loop in ast.walk(module.tree):
        if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
            continue
        for part in _loop_parts(loop):
            for node in ast.walk(part):
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                fn = node.func
                msg = None
                if isinstance(fn, ast.Attribute) and \
                        fn.attr in SYNC_METHODS and not node.args \
                        and not node.keywords:
                    msg = (f".{fn.attr}() in a loop — a device->host sync "
                           "per iteration on a tensor; keep the value on the "
                           "device, or read once after the loop")
                elif (isinstance(fn, ast.Name)
                      and fn.id in ("bool", "int", "float")
                      and len(node.args) == 1
                      and _reduction_call(node.args[0])):
                    msg = (f"{fn.id}() of a reduction in a loop — a "
                           "device->host sync per iteration; keep the "
                           "predicate on the device, or count the read "
                           "where the loop needs it")
                if msg is not None:
                    seen.add(id(node))
                    yield node, msg
