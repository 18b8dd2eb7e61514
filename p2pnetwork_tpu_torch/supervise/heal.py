"""Self-healing recovery: integrity checks and policy-routed chunk retry
(the port's counterpart of ``p2pnetwork_tpu/supervise/heal.py``, with
its classes, checks, metric names and messages).

``supervise/runner.py`` recovers from process death (checkpoint and
resume); this module recovers from detected bad state — a corrupted halo
word, a chip lost mid-traffic, a wedged dispatch:

- **Detection**: end-of-chunk integrity checks on the harvested state,
  raised as :class:`IntegrityViolation` naming the check, the leaf and the
  chunk: a shape/dtype/finiteness audit against a template
  (:func:`audit_state`), monotonicity of the batch plane's latched
  progress (:func:`check_monotonic`), and an optional checksum
  cross-validation against a reference fold (:func:`state_checksum`).
- **Recovery**: :class:`RetryPolicy` (exponential backoff with seeded
  jitter, an attempt budget, per-failure-class routing) driving
  :meth:`Healer.run_chunk`: roll the chunk back to its input (the
  retained input, or the newest entry of a ``CheckpointStore``),
  optionally reroute to a fallback dispatch, re-execute. Chunk keys are
  the driver's schedule, so a healed re-run is bit-identical to a chunk
  that never faulted.

Leaves are named and hashed as the reference names and hashes them: a
state is walked in JAX's pytree order and each leaf named by its
``keystr`` path (``.seen``, ``[0]``, ``['key']``); the packed predicate
words a state class lists in ``U32_WORDS`` (held as ``int32`` here) are
hashed and audited as the reference's ``uint32``, so equal states give
equal :func:`state_checksum` digests in both packages. The checks read
the harvested state in one host pull per chunk (all its leaves, plus the
input's four latched-progress leaves when monotonicity applies), counted
in ``_device.SYNCS``; torch has no buffer donation, so the retained
input is the caller's own state object, untouched by the dispatch.

Retries count into ``heal_retries_total{outcome}`` (``retry`` /
``fallback`` decisions, ``healed`` chunks, ``exhausted`` budgets);
integrity failures into ``quake_integrity_failures_total{kind}`` and
rollbacks into ``heal_rollbacks_total{source}``; the trace plane gets
``heal_retry`` / ``heal_rollback`` / ``heal_recovered`` events.
:attr:`Healer.last_report` keeps the latest chunk's attempt history.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, List, Mapping, Optional, Tuple

import numpy as np

from p2pnetwork_tpu_torch import concurrency, telemetry
from p2pnetwork_tpu_torch.chaos.device import ChipLost, WedgedDispatch
from p2pnetwork_tpu_torch.supervise.watchdog import StallTimeout
from p2pnetwork_tpu_torch.telemetry import spans

__all__ = [
    "IntegrityViolation", "RetryPolicy", "Healer", "classify_failure",
    "audit_state", "check_monotonic", "state_checksum",
]

#: Healer retry-policy actions a failure class can route to.
ACTIONS = ("retry", "fallback", "raise")

#: Default per-failure-class routing: deterministic comm corruption
#: (integrity) re-runs the same faults if retried in place, so it routes
#: to the fallback path; one-shot dispatch faults retry where they ran.
DEFAULT_ROUTES: Mapping[str, str] = {
    "integrity": "fallback",
    "preempt": "retry",
    "wedged": "retry",
}

#: The batch plane's latched-progress leaves (:func:`check_monotonic`).
_LATCHED = ("seen", "seen_count", "done", "rounds")


class IntegrityViolation(RuntimeError):
    """A detected-bad-state failure: the end-of-chunk integrity checks
    rejected a harvested state. ``kind`` names the check (``template`` /
    ``nonfinite`` / ``monotonicity`` / ``checksum``), ``leaf`` the
    failing state leaf, ``chunk`` the chunk index, ``shard`` the shard
    when the check localizes one."""

    def __init__(self, kind: str, *, leaf: str = "", chunk: int = -1,
                 shard: Optional[int] = None, detail: str = ""):
        self.kind = kind
        self.leaf = leaf
        self.chunk = int(chunk)
        self.shard = shard
        self.detail = detail
        where = f"chunk {chunk}" + (f", shard {shard}"
                                    if shard is not None else "")
        what = f" leaf {leaf!r}" if leaf else ""
        tail = f": {detail}" if detail else ""
        super().__init__(f"integrity violation [{kind}] at {where}{what}"
                         f"{tail}")


# ------------------------------------------------------------ tree walk


def _is_node(x) -> bool:
    return (x is None or isinstance(x, (dict, list, tuple))
            or (dataclasses.is_dataclass(x) and not isinstance(x, type)))


def _named(state) -> List[Tuple[str, Any, bool]]:
    """``[(keystr path, leaf, is_u32_words)]`` in JAX's flattening
    order: dataclass fields and namedtuple fields as ``.name``, sequence
    items as ``[i]``, dict entries (sorted keys) as ``[key!r]``."""
    out: List[Tuple[str, Any, bool]] = []

    def walk(x, path, words):
        if x is None:
            return
        if not _is_node(x):
            out.append((path, x, words))
            return
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{path}[{k!r}]", False)
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for name in x._fields:
                walk(getattr(x, name), f"{path}.{name}", False)
        elif isinstance(x, (list, tuple)):
            for i, c in enumerate(x):
                walk(c, f"{path}[{i}]", False)
        else:
            u32 = getattr(type(x), "U32_WORDS", ())
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), f"{path}.{f.name}", f.name in u32)
    walk(state, "", False)
    return out


def _as_words(arr: np.ndarray, words: bool) -> np.ndarray:
    return arr.view(np.uint32) if words and arr.dtype == np.int32 else arr


def _pull(leaves) -> List[np.ndarray]:
    """Every leaf on the host, in one device->host pull: device tensors
    are copied without blocking and read after one synchronization,
    counted in ``_device.SYNCS`` (nothing is counted when no leaf lives
    on a device)."""
    import torch

    from p2pnetwork_tpu_torch import _device

    out, pending = [], []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            if leaf.device.type == "cpu":
                out.append(leaf.numpy())
                continue
            host = torch.empty(leaf.shape, dtype=leaf.dtype,
                               pin_memory=True)
            host.copy_(leaf, non_blocking=True)
            pending.append(leaf.device)
            out.append(host)
        else:
            out.append(np.asarray(leaf))
    if pending:
        for dev in set(pending):
            torch.cuda.current_stream(dev).synchronize()
        _device.SYNCS += 1
        out = [x.numpy() if isinstance(x, torch.Tensor) else x for x in out]
    return out


def _host_named(state) -> List[Tuple[str, np.ndarray]]:
    named = _named(state)
    arrs = _pull([leaf for _, leaf, _ in named])
    return [(name, _as_words(a, w)) for (name, _, w), a in zip(named, arrs)]


def _signature(leaf, words: bool) -> Tuple[tuple, str]:
    """``(shape, numpy dtype name)`` of a leaf without reading it."""
    import torch

    if isinstance(leaf, torch.Tensor):
        dtype = torch.empty((), dtype=leaf.dtype).numpy().dtype
        shape = tuple(leaf.shape)
    else:
        arr = np.asarray(leaf)
        dtype, shape = arr.dtype, arr.shape
    if words and dtype == np.int32:
        dtype = np.dtype(np.uint32)
    return shape, str(dtype)


def host_template(state):
    """A template of ``state`` for :func:`audit_state`: the same tree
    with every leaf a numpy zero array of its shape and dtype (packed
    words as ``uint32``) — the reference's ``tree_map(np.zeros(shape,
    dtype))``. Reads no device value."""
    from p2pnetwork_tpu_torch.sim import checkpoint as ckpt

    sigs = [np.zeros(*_signature(leaf, w)) for _, leaf, w in _named(state)]
    return ckpt._unflatten(state, sigs)


# --------------------------------------------------------------- checks


def _audit_host(got, want, chunk: int) -> None:
    if len(got) != len(want):
        raise IntegrityViolation(
            "template", chunk=chunk,
            detail=f"state has {len(got)} leaves, template {len(want)}")
    for (name, arr), (shape_t, dtype_t) in zip(got, want):
        shape, dtype = tuple(arr.shape), str(arr.dtype)
        if shape != shape_t or dtype != dtype_t:
            raise IntegrityViolation(
                "template", leaf=name, chunk=chunk,
                detail=f"got {shape}/{dtype}, template "
                       f"{shape_t}/{dtype_t}")
        if np.issubdtype(arr.dtype, np.floating) \
                and not np.isfinite(arr).all():
            raise IntegrityViolation(
                "nonfinite", leaf=name, chunk=chunk,
                detail="non-finite values in a float leaf")


def _template_sigs(template):
    return [_signature(leaf, w) for _, leaf, w in _named(template)]


def audit_state(state, template, *, chunk: int = -1) -> None:
    """Template audit of a harvested state: every leaf must match the
    template's shape and dtype (numpy names, packed words as
    ``uint32``), and float leaves must be finite. Raises
    :class:`IntegrityViolation` on the first failing leaf."""
    _audit_host(_host_named(state), _template_sigs(template), chunk)


def _latched(state) -> bool:
    return all(hasattr(state, f) for f in _LATCHED)


def _check_monotonic_host(prev: dict, curr: dict, chunk: int) -> None:
    lost = _as_words(prev["seen"], True) & ~_as_words(curr["seen"], True)
    if lost.any():
        raise IntegrityViolation(
            "monotonicity", leaf="seen", chunk=chunk,
            detail=f"{int(np.count_nonzero(lost))} seen words lost bits")
    if (curr["seen_count"] < prev["seen_count"]).any():
        raise IntegrityViolation(
            "monotonicity", leaf="seen_count", chunk=chunk,
            detail="per-lane coverage numerator regressed")
    if (curr["rounds"] < prev["rounds"]).any():
        raise IntegrityViolation(
            "monotonicity", leaf="rounds", chunk=chunk,
            detail="per-lane round counter regressed")
    if (prev["done"] & ~curr["done"]).any():
        raise IntegrityViolation(
            "monotonicity", leaf="done", chunk=chunk,
            detail="a completed lane's done flag unlatched")


def check_monotonic(prev, curr, *, chunk: int = -1) -> None:
    """Monotonicity between one chunk's input and output for batch-plane
    states (duck-typed on the MessageBatch fields; other states pass):
    seen bits only gain, per-lane seen counts and round counts never
    regress, done never unlatches. Assumes a fixed live population
    between input and output, as the reference does."""
    if not _latched(curr):
        return
    arrs = _pull([getattr(s, f) for s in (prev, curr) for f in _LATCHED])
    n = len(_LATCHED)
    _check_monotonic_host(dict(zip(_LATCHED, arrs[:n])),
                          dict(zip(_LATCHED, arrs[n:])), chunk)


def state_checksum(state) -> str:
    """sha256 over every leaf's name, numpy dtype name, shape and bytes,
    in flattening order: the bit-identity witness, equal to the
    reference's digest of an equal state."""
    h = hashlib.sha256()
    for name, arr in _host_named(state):
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


# --------------------------------------------------------------- policy


def _seeded_unit(seed: int, salt: int, attempt: int) -> float:
    """Deterministic uniform in [0, 1) from (seed, salt, attempt): a
    sha256 fold, identical on every platform."""
    digest = hashlib.sha256(
        f"{seed}:{salt}:{attempt}".encode()).digest()
    return int.from_bytes(digest[:8], "big") / float(1 << 64)


def classify_failure(exc: BaseException) -> Optional[str]:
    """The failure class a retry policy routes on, or None for
    exceptions healing must not swallow (caller errors, supervise
    ``Preempted`` kills, anything unknown)."""
    if isinstance(exc, IntegrityViolation):
        return "integrity"
    if isinstance(exc, ChipLost):
        return "preempt"
    if isinstance(exc, (WedgedDispatch, StallTimeout)):
        return "wedged"
    return None


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with seeded jitter plus per-class routing.

    ``backoff_s(attempt)`` is ``backoff_base_s * 2**(attempt-1)`` capped
    at ``backoff_max_s``, jittered by ``±jitter/2`` of itself with a
    sha256-seeded uniform: the same (seed, salt, attempt) gives the same
    delay on any platform. ``routes`` maps a failure class
    (:func:`classify_failure`) to an action in :data:`ACTIONS`;
    unlisted classes raise."""

    max_attempts: int = 3
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    jitter: float = 0.5
    seed: int = 0
    routes: Mapping[str, str] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_ROUTES))

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.backoff_base_s < 0 or self.backoff_max_s < 0:
            raise ValueError("backoff seconds must be >= 0")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        for cls, action in self.routes.items():
            if action not in ACTIONS:
                raise ValueError(
                    f"route for {cls!r} must be one of {ACTIONS}, "
                    f"got {action!r}")

    def backoff_s(self, attempt: int, salt: int = 0) -> float:
        """Delay before retrying after the ``attempt``-th failure
        (1-based)."""
        if attempt < 1:
            raise ValueError("attempt is 1-based")
        base = min(self.backoff_base_s * (2.0 ** (attempt - 1)),
                   self.backoff_max_s)
        u = _seeded_unit(self.seed, salt, attempt)
        return max(0.0, base * (1.0 + self.jitter * (u - 0.5)))

    def delays(self, n: int, salt: int = 0):
        """The first ``n`` backoff delays."""
        return [self.backoff_s(a, salt) for a in range(1, n + 1)]

    def action_for(self, failure_class: Optional[str]) -> str:
        return self.routes.get(failure_class, "raise") \
            if failure_class is not None else "raise"


# --------------------------------------------------------------- healer


def _on_device(tree, like):
    """``tree``'s numpy leaves as tensors on the device of ``like``'s
    first tensor leaf (packed ``uint32`` words as ``int32``, same bits);
    tensor leaves are moved there."""
    import torch

    from p2pnetwork_tpu_torch.sim import checkpoint as ckpt

    dev = next((leaf.device for _, leaf, _ in _named(like)
                if isinstance(leaf, torch.Tensor)), torch.device("cpu"))

    def move(leaf):
        if isinstance(leaf, torch.Tensor):
            return leaf.to(dev)
        arr = np.asarray(leaf)
        if arr.dtype == np.uint32:
            arr = arr.view(np.int32)
        return torch.from_numpy(np.array(arr)).to(dev)
    return ckpt._unflatten(tree, [move(leaf) for _, leaf, _ in _named(tree)])


class Healer:
    """The recovery engine: wrap a chunk dispatch with integrity checks,
    rollback and policy-routed retry.

    ``dispatch`` callables are ``state -> (state, out)`` and must leave
    their input intact (the port's engine loops never modify their
    input): it is the rollback state and the monotonicity baseline.
    Rollback prefers the configured ``CheckpointStore``'s newest
    loadable entry (``store`` + ``template``), placed on the retained
    input's device, and falls back to the retained input.

    Checks per attempt: the template audit (when ``template`` is set),
    monotonicity (``monotonic=True``, batch-plane states), and the
    checksum cross-validation when a ``verify`` dispatch is given.
    """

    def __init__(self, policy: Optional[RetryPolicy] = None, *,
                 template: Any = None, monotonic: bool = True,
                 fallback_dispatch: Optional[Callable] = None,
                 verify_dispatch: Optional[Callable] = None,
                 store=None,
                 registry: Optional[telemetry.Registry] = None,
                 sleep: Optional[Callable[[float], None]] = None):
        self.policy = policy if policy is not None else RetryPolicy()
        self.template = template
        self.monotonic = bool(monotonic)
        self.fallback_dispatch = fallback_dispatch
        self.verify_dispatch = verify_dispatch
        self.store = store
        self._sleep = sleep if sleep is not None else concurrency.sleep
        reg = registry if registry is not None \
            else telemetry.default_registry()
        self._m_retries = reg.counter(
            "heal_retries_total",
            "Healing decisions by outcome: retry/fallback route taken, "
            "healed chunk recovered, exhausted attempt budget.",
            ("outcome",))
        self._m_integrity = reg.counter(
            "quake_integrity_failures_total",
            "Integrity-check rejections by check kind "
            "(template/nonfinite/monotonicity/checksum).",
            ("kind",))
        self._m_rollbacks = reg.counter(
            "heal_rollbacks_total",
            "Chunk rollbacks before a retry, by rollback source: the "
            "checkpoint store's newest entry or the retained undonated "
            "input.", ("source",))
        #: Attempt history of the most recent :meth:`run_chunk` call —
        #: ``{"chunk", "attempts", "healed", "fallback", "exhausted",
        #: "events": [{"attempt", "failure", "action", "degraded",
        #: "integrity_kind"?, "leaf"?}, ...]}``; ``None`` until the
        #: first chunk.
        self.last_report: Optional[dict] = None

    # ------------------------------------------------------------ checks

    def check(self, prev, state, *, chunk: int = -1) -> None:
        """The cheap always-on checks (template, finiteness,
        monotonicity): one host pull of the harvested state per chunk,
        with the input's latched-progress leaves in the same pull when
        monotonicity applies. States the monotonicity duck-typing
        rejects (protocol states) cost nothing unless a template is
        set."""
        monotonic_applies = (self.monotonic and prev is not None
                             and _latched(state))
        if self.template is None and not monotonic_applies:
            return
        named = _named(state)
        leaves = [leaf for _, leaf, _ in named]
        if monotonic_applies:
            leaves += [getattr(prev, f) for f in _LATCHED]
        arrs = _pull(leaves)
        got = [(name, _as_words(a, w))
               for (name, _, w), a in zip(named, arrs)]
        if self.template is not None:
            _audit_host(got, _template_sigs(self.template), chunk)
        if monotonic_applies:
            by_name = dict(got)
            curr = {f: by_name[f".{f}"] for f in _LATCHED}
            prev_h = dict(zip(_LATCHED, arrs[len(named):]))
            _check_monotonic_host(prev_h, curr, chunk)

    # ------------------------------------------------------------- drive

    def _rollback_input(self, retained, chunk: int):
        if self.store is not None and self.template is not None:
            restored = self.store.load_latest(self.template)
            if restored is not None:
                self._m_rollbacks.labels("store").inc()
                if spans.current_tracer() is not None:
                    spans.emit("heal_rollback", chunk=chunk,
                               round=int(restored[2]),
                               path=restored[4])
                return _on_device(restored[0], retained)
        self._m_rollbacks.labels("retained").inc()
        if spans.current_tracer() is not None:
            spans.emit("heal_rollback", chunk=chunk, round=-1,
                       path="")
        return retained

    def run_chunk(self, dispatch: Callable, state, *, chunk_index: int = -1,
                  salt: Optional[int] = None,
                  fallback: Optional[Callable] = None,
                  verify: Optional[Callable] = None):
        """Execute one chunk with healing; returns ``(state, out)``.

        ``fallback`` / ``verify`` override the healer-level dispatches
        for this chunk. Unroutable failures propagate untouched; a
        routable failure rolls back, backs off (seeded) and re-executes,
        on the fallback path when the policy says so, until the attempt
        budget is spent."""
        fallback = fallback if fallback is not None \
            else self.fallback_dispatch
        verify = verify if verify is not None else self.verify_dispatch
        salt = chunk_index if salt is None else salt
        current = dispatch
        on_fallback = False
        failed = False
        attempt = 0
        report = {"chunk": int(chunk_index), "attempts": 0,
                  "healed": False, "fallback": False, "exhausted": False,
                  "events": []}
        self.last_report = report
        while True:
            attempt += 1
            report["attempts"] = attempt
            inp = state if attempt == 1 \
                else self._rollback_input(state, chunk_index)
            try:
                new_state, out = current(inp)
                self.check(inp, new_state, chunk=chunk_index)
                if verify is not None and not on_fallback:
                    ref_state, _ = verify(inp)
                    if state_checksum(new_state) != state_checksum(ref_state):
                        raise IntegrityViolation(
                            "checksum", chunk=chunk_index,
                            detail="chunk result diverges from the "
                                   "replicated reference fold")
                if failed:
                    report["healed"] = True
                    report["fallback"] = on_fallback
                    self._m_retries.labels("healed").inc()
                    if spans.current_tracer() is not None:
                        spans.emit("heal_recovered", chunk=chunk_index,
                                   attempts=attempt,
                                   fallback=on_fallback)
                return new_state, out
            except (IntegrityViolation, ChipLost, WedgedDispatch,
                    StallTimeout) as e:
                failed = True
                cls = classify_failure(e)
                entry = {"attempt": attempt, "failure": cls,
                         "action": "", "degraded": False}
                if isinstance(e, IntegrityViolation):
                    entry["integrity_kind"] = e.kind
                    entry["leaf"] = e.leaf
                    self._m_integrity.labels(e.kind).inc()
                report["events"].append(entry)
                action = self.policy.action_for(cls)
                if action == "raise" or attempt >= self.policy.max_attempts:
                    # "exhausted" counts budget overruns only.
                    if attempt >= self.policy.max_attempts:
                        report["exhausted"] = True
                        self._m_retries.labels("exhausted").inc()
                    entry["action"] = "raise"
                    raise
                # A fallback route with no fallback dispatch degrades to
                # an in-place retry, made visible in the event.
                degraded = action == "fallback" and fallback is None
                if action == "fallback" and not degraded:
                    current = fallback
                    on_fallback = True
                    outcome = "fallback"
                else:
                    outcome = "retry"
                entry["action"] = outcome
                entry["degraded"] = degraded
                self._m_retries.labels(outcome).inc()
                if spans.current_tracer() is not None:
                    spans.emit("heal_retry", chunk=chunk_index,
                               attempt=attempt, failure=cls,
                               action=outcome, degraded=degraded,
                               integrity_kind=entry.get("integrity_kind",
                                                        ""))
                delay = self.policy.backoff_s(attempt, salt=salt)
                if delay > 0:
                    self._sleep(delay)
