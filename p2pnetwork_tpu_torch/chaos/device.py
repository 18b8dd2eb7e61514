"""Device-plane fault injection (the port's counterpart of
``p2pnetwork_tpu/chaos/device.py``): seeded halo-hop faults for the ring
and one-shot dispatch faults for the engine and serving loops.

- **Halo-hop faults** (:class:`FaultSchedule` + :class:`FaultSpec`): a
  ``comm=`` value for ``parallel/sharded.py`` that wraps a halo backend
  (``ppermute`` / ``pallas``) in a :class:`FaultyComm`. On ring step
  ``t`` of round ``r``, the block shard ``d`` receives is corrupted
  (seeded sparse bit-flips), zeroed (hop lost) or delayed (the shard
  keeps its own block) when the schedule says so.

- **Dispatch faults** (:class:`DispatchChaos`): a chip preemption
  (:class:`ChipLost`) or a wedged dispatch (:class:`WedgedDispatch`)
  raised at the chunk dispatch gate of ``engine.run_from``,
  ``engine.run_until_coverage_from`` and
  ``engine.run_batch_until_coverage``. Armings are one-shot, so a retry
  (``supervise/heal.py``) lands on a healthy dispatch.

The sites are the reference's: the kind at ``(round, step, shard)`` is
drawn from ``fold_in(fold_in(fold_in(key(seed), round), step), shard)``
and the corrupt bits from that key folded with 1, by jax 0.9.0's
threefry (``prng.py``). The reference traces that draw inside its
compiled ring loop; the port's ring loop runs on the host, where round,
step and shard are integers at every hop, so :meth:`FaultSchedule.kinds`
hashes the sites' keys in numpy (no device work, no sync; a
``FaultyComm`` hashes a round's sites at its first hop) and only a
corrupt site draws on the device (``prng.bernoulli`` and
``prng.random_bits``, the threefry kernel on a card). 1- and 2-byte
payloads take the low bits of the 32-bit draw, as ``jax.random.bits`` of
``uint8``/``uint16`` does.

Injections count into ``chaos_device_faults_total{kind}``; the halo
counts are a host replay of the schedule over the rounds a run executed
(:func:`record_faults`), so the counter reflects the schedule exactly.
Importing this module builds nothing and touches no device; the gate
costs the engines one attribute read and a None check when nothing is
installed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from p2pnetwork_tpu_torch import concurrency, telemetry
from p2pnetwork_tpu_torch.telemetry import spans

__all__ = [
    "FAULT_KINDS", "FaultSchedule", "FaultSpec", "FaultyComm",
    "ChipLost", "WedgedDispatch", "DispatchChaos", "UnreachableFaultSite",
    "install_dispatch_chaos", "dispatch_gate", "record_faults",
]

#: Halo-hop fault kinds, in code order (code = index + 1; 0 = none).
FAULT_KINDS = ("corrupt", "zero", "delay")
_KIND_CODE = {k: i + 1 for i, k in enumerate(FAULT_KINDS)}

#: The concrete backends a FaultSpec wraps (``parallel/auto.COMM_BACKENDS``).
_BACKENDS = ("ppermute", "pallas")


def _faults_counter(registry: Optional[telemetry.Registry] = None):
    reg = registry if registry is not None else telemetry.default_registry()
    return reg.counter(
        "chaos_device_faults_total",
        "Device-plane faults injected by graftquake, by kind (corrupt / "
        "zero / delay halo hops from a FaultSchedule; preempt / wedge "
        "dispatch faults from DispatchChaos).", ("kind",))


class UnreachableFaultSite(UserWarning):
    """An explicit ``FaultSchedule.sites`` entry can never fire on the
    ring it was handed to: its step or shard index is outside
    ``[0, axis_size)`` (e.g. a schedule written for another shard
    count). Loud (this warning plus a ``fault_sites_unreachable`` trace
    event) but not fatal: the in-range sites still inject."""


class ChipLost(RuntimeError):
    """An injected chunk-boundary chip preemption: the gate raises before
    the dispatch touches any state. Healable: the arming is one-shot."""

    def __init__(self, dispatch_index: int):
        self.dispatch_index = int(dispatch_index)
        super().__init__(
            f"injected chip preemption at dispatch {dispatch_index} "
            "(chaos/device.DispatchChaos)")


class WedgedDispatch(RuntimeError):
    """An injected wedged device dispatch: the testable stand-in for the
    stall a watchdog detects (``supervise/watchdog.py``)."""

    def __init__(self, dispatch_index: int):
        self.dispatch_index = int(dispatch_index)
        super().__init__(
            f"injected wedged dispatch at index {dispatch_index} "
            "(chaos/device.DispatchChaos)")


# ------------------------------------------------------ halo-hop faults


def _fold_in(k0, k1, data):
    """``prng.fold_in`` over numpy arrays of key words and data (i64
    holding u32 values): threefry of the counter pair ``(0, data)``."""
    from p2pnetwork_tpu_torch.ops.threefry import threefry2x32

    return threefry2x32(k0, k1, np.zeros_like(data), data & 0xFFFFFFFF)


def _uniform0(k0, k1) -> np.ndarray:
    """``uniform(k, ())`` of each key: the f32 of the top 23 bits of the
    draw at counter 0, as a mantissa in [1, 2), minus 1."""
    from p2pnetwork_tpu_torch.ops.threefry import threefry2x32

    zero = np.zeros_like(k0)
    x0, x1 = threefry2x32(k0, k1, zero, zero)
    bits = ((x0 ^ x1) >> 9) | 0x3F800000
    return bits.astype(np.uint32).view(np.float32) - np.float32(1.0)


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A seeded, byte-replayable schedule of halo-hop faults (the
    reference's fields and semantics).

    Every (round, step, shard) site draws one uniform from
    ``fold_in(fold_in(fold_in(key(seed), round), step), shard)`` folded
    with 0 and maps it through the ``corrupt``/``zero``/``delay``
    probability thresholds. ``round`` is the GLOBAL round (chunked
    drivers pass ``fault_round0``); sites outside ``[start_round,
    stop_round)`` draw nothing. ``sites`` adds explicit placements
    ``(round, step, shard, kind)`` on top; they ignore the window.

    Kinds, applied to the block shard ``d`` RECEIVES at that hop:
    ``corrupt`` XORs a ``corrupt_density`` fraction of the payload's
    elements with a random nonzero pattern (bools flip); ``zero`` loses
    the hop; ``delay`` stalls the rotation, so the shard keeps its own
    pre-shift block.
    """

    seed: int = 0
    corrupt: float = 0.0
    zero: float = 0.0
    delay: float = 0.0
    start_round: int = 0
    stop_round: int = 1 << 30
    corrupt_density: float = 1.0 / 64.0
    sites: Tuple[Tuple[int, int, int, str], ...] = ()

    def __post_init__(self):
        # Coerce list-form sites to tuples: the schedule stays hashable.
        object.__setattr__(self, "sites",
                           tuple(tuple(s) for s in self.sites))
        total = self.corrupt + self.zero + self.delay
        if min(self.corrupt, self.zero, self.delay) < 0 or total > 1.0:
            raise ValueError(
                "fault probabilities must be >= 0 and sum to <= 1, got "
                f"corrupt={self.corrupt} zero={self.zero} "
                f"delay={self.delay}")
        if not 0.0 < self.corrupt_density <= 1.0:
            raise ValueError("corrupt_density must be in (0, 1]")
        for site in self.sites:
            if len(site) != 4 or site[3] not in _KIND_CODE:
                raise ValueError(
                    f"schedule site must be (round, step, shard, kind) "
                    f"with kind in {FAULT_KINDS}, got {site!r}")

    @property
    def active(self) -> bool:
        """False for the empty schedule — FaultyComm then passes every
        hop through untouched (bit-identical to the bare backend)."""
        return bool(self.sites) or (self.corrupt + self.zero
                                    + self.delay) > 0.0

    def _site_key(self, rnd, step, shard):
        """The site keys' two words, over numpy arrays of sites."""
        from p2pnetwork_tpu_torch import prng

        k = prng.key(self.seed).astype(np.int64)
        k0, k1 = np.full_like(rnd, k[0]), np.full_like(rnd, k[1])
        for data in (rnd, step, shard):
            k0, k1 = _fold_in(k0, k1, data)
        return k0, k1

    def kinds(self, rnd, step, shard) -> np.ndarray:
        """Fault-kind codes (``i32``: 0 none, 1 corrupt, 2 zero, 3 delay)
        at the sites ``(rnd, step, shard)``, each an int or an integer
        array (broadcast together). The draw is the reference's
        ``kind_at``: the uniform compared in f32 with the cumulative
        thresholds, the window, then the explicit sites."""
        return self._kinds_and_keys(rnd, step, shard)[0]

    def _kinds_and_keys(self, rnd, step, shard):
        """:meth:`kinds` and the sites' key words ``(k0, k1)``, which a
        corrupt site's draw reuses."""
        rnd, step, shard = (a.astype(np.int64) for a in np.broadcast_arrays(
            *(np.asarray(v, dtype=np.int64) for v in (rnd, step, shard))))
        keys = self._site_key(rnd, step, shard)
        kind = np.zeros(rnd.shape, dtype=np.int32)
        p_c, p_z, p_d = self.corrupt, self.zero, self.delay
        if p_c + p_z + p_d > 0.0:
            u = _uniform0(*_fold_in(*keys, np.zeros_like(rnd)))
            # The thresholds as the reference compares them: Python
            # sums, each rounded to f32.
            t1, t2, t3 = (np.float32(p_c), np.float32(p_c + p_z),
                          np.float32(p_c + p_z + p_d))
            kind = np.where(u < t1, 1, np.where(
                u < t2, 2, np.where(u < t3, 3, 0))).astype(np.int32)
            in_window = (rnd >= self.start_round) & (rnd < self.stop_round)
            kind = np.where(in_window, kind, 0).astype(np.int32)
        for sr, st, sd, sk in self.sites:
            hit = (rnd == sr) & (step == st) & (shard == sd)
            kind = np.where(hit, _KIND_CODE[sk], kind).astype(np.int32)
        return kind, keys

    def kind_at(self, rnd: int, step: int, shard: int) -> int:
        """The fault-kind code at one site (see :meth:`kinds`)."""
        return int(self.kinds(rnd, step, shard))

    def corrupt_payload(self, payload, rnd: int, step: int, shard: int):
        """The seeded bit-flipped form of one hop's payload (a tensor:
        same shape and dtype; a ``corrupt_density`` fraction of elements
        XOR a random nonzero pattern, floats through a bit view, so
        NaN/Inf patterns are possible). Draws on the payload's device:
        ``bernoulli`` of the mask and, for non-bool payloads, 32-bit
        ``random_bits`` whose low 8/16/32 bits are the pattern."""
        return self._corrupt(payload, *self._site_key(
            *(np.asarray(v, dtype=np.int64) for v in (rnd, step, shard))))

    def _corrupt(self, payload, k0, k1):
        """:meth:`corrupt_payload` at the site whose key words are
        ``(k0, k1)``."""
        import torch

        from p2pnetwork_tpu_torch import prng

        k = np.array(_fold_in(k0, k1, np.int64(1)), dtype=np.uint32)
        k_mask, k_bits = prng.split(k)
        shape, dev = tuple(payload.shape), payload.device
        flip = prng.bernoulli(k_mask, self.corrupt_density, shape,
                              device=dev)
        if payload.dtype == torch.bool:
            return payload ^ flip
        itemsize = payload.element_size()
        word = {1: torch.uint8, 2: torch.int16, 4: torch.int32}.get(itemsize)
        if word is None:
            raise NotImplementedError(
                f"corrupt fault has no bit-flip form for {payload.dtype} "
                "(64-bit payloads need jax x64 in the reference)")
        words = payload if payload.dtype == word else payload.view(word)
        bits = prng.random_bits(k_bits, shape, device=dev)
        if itemsize == 1:
            bits = (bits & 0xFF).to(torch.uint8)
        elif itemsize == 2:
            bits = bits & 0xFFFF
            bits = torch.where(bits >= 0x8000, bits - 0x10000,
                               bits).to(torch.int16)
        bits = bits | 1
        words = torch.where(flip, words ^ bits, words)
        return words if payload.dtype == word else words.view(payload.dtype)

    def sites_between(self, round0: int, round1: int, n_steps: int,
                      n_shards: int):
        """Host replay: every fault site with ``round0 <= round <
        round1`` over ``n_steps`` hops per round and ``n_shards`` shards,
        as ``[(round, step, shard, kind), ...]`` sorted by site — the
        sites a faulted run applies."""
        if round1 <= round0 or n_steps <= 0 or n_shards <= 0 \
                or not self.active:
            return []
        rr, tt, dd = np.meshgrid(
            np.arange(round0, round1), np.arange(n_steps),
            np.arange(n_shards), indexing="ij")
        kinds = self.kinds(rr.ravel(), tt.ravel(), dd.ravel())
        hit = np.flatnonzero(kinds)
        return [(int(rr.flat[i]), int(tt.flat[i]), int(dd.flat[i]),
                 FAULT_KINDS[int(kinds[i]) - 1]) for i in hit]

    def counts_between(self, round0: int, round1: int, n_steps: int,
                       n_shards: int):
        """Fault counts by kind over the same window — what
        :func:`record_faults` feeds ``chaos_device_faults_total``."""
        counts = {k: 0 for k in FAULT_KINDS}
        for _, _, _, kind in self.sites_between(round0, round1, n_steps,
                                                n_shards):
            counts[kind] += 1
        return counts


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """A ``comm=`` value for the ring's entry points: run the ring on
    ``backend`` with ``schedule``'s faults injected at the halo hops.
    ``flood_until_coverage`` feeds the ring the global round via
    ``fault_round0``; ``propagate`` runs at round 0. ``backend`` must be
    concrete ("ppermute" or "pallas": resolve "auto" with
    ``parallel/auto.resolve_comm`` first)."""

    schedule: FaultSchedule
    backend: str = "ppermute"

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(
                f"FaultSpec.backend must be one of {_BACKENDS} (resolve "
                f"'auto' before building the spec), got {self.backend!r}")

    def make(self, axis_name: str, axis_size: int, *,
             mesh=None) -> "FaultyComm":
        """The ring's comm seam: this spec's comm object for one ring of
        ``axis_size`` shards; ``mesh`` is the rank mesh of a ring split
        over processes (``parallel/mesh.RingMesh``, ``world > 1``), None
        in one process. Explicit sites whose step or shard lies outside
        ``[0, axis_size)`` can never fire and draw an
        :class:`UnreachableFaultSite` warning."""
        import warnings

        stale = [s for s in self.schedule.sites
                 if not (0 <= s[1] < axis_size and 0 <= s[2] < axis_size)]
        if stale:
            warnings.warn(
                f"{len(stale)} explicit fault site(s) unreachable on "
                f"ring axis {axis_name!r} (size {axis_size}): "
                f"{stale[:8]!r}{' ...' if len(stale) > 8 else ''} — "
                "step/shard must lie in [0, axis_size); a schedule "
                "authored before overlay growth must be re-targeted",
                UnreachableFaultSite, stacklevel=2)
            if spans.current_tracer() is not None:
                spans.emit("fault_sites_unreachable", axis=axis_name,
                           axis_size=int(axis_size), n_stale=len(stale),
                           sites=[list(s) for s in stale[:16]])
        return FaultyComm(self, axis_name, axis_size, mesh=mesh)


class FaultyComm:
    """The ring comm seam's interface with the schedule's faults injected
    into the forward hops. The inner backend does the real transfer
    (``ops/ring.py``'s B2 kernel for ``pallas`` on a card) and the
    payload-template check; this layer rewrites what each shard receives,
    keyed on ``(round, step, shard)``: round and step arrive through
    :meth:`set_context` (the ring pass sets the step before each hop,
    the flood loop the round before each pass), the shard is the row of
    the stacked payload (on a ring split over ranks, ``mesh.shard_lo``
    plus the row: the global shard). The kinds of every (step, shard)
    this process holds in the current round are hashed together on the
    host at its first hop, no device work and no sync: the numpy key
    chain costs about the same for one site as for a round's.

    Across ranks the inner backend is the rank comm
    (``parallel/sharded.py::_RankComm``): every hop's cross-rank put
    runs, faulted or not, so no peer waits on a put that never comes,
    and the fault rewrites what landed.

    ``shift_back`` stays clean (the sites name forward hops). ``fuses``
    is False: the fused hop-and-sum kernel (B3) never exposes the hop's
    payload, so a faulted ``mxu`` pass runs B2's hop and B1's stacked
    apply instead, which the reference pins bit-identical to the fused
    form.
    """

    wants_step = True
    fuses = False

    def __init__(self, spec: FaultSpec, axis_name: str, axis_size: int,
                 *, mesh=None):
        from p2pnetwork_tpu_torch.parallel.sharded import _RankComm, _RingComm

        if mesh is not None and mesh.world > 1:
            self._inner = _RankComm(spec.backend, mesh)
            self._shards = np.arange(mesh.shard_lo,
                                     mesh.shard_lo + mesh.n_local)
        else:
            self._inner = _RingComm(spec.backend, axis_size)
            self._shards = np.arange(axis_size)
        self.backend = spec.backend
        self.axis_name = axis_name
        self.axis_size = axis_size
        self.schedule = spec.schedule
        self._round = None
        self._step = None
        # This round's kinds and site key words, [step, shard held here].
        self._round_sites = None

    def set_context(self, round=None, step=None):
        """Record the round / step the next hops belong to."""
        if round is not None and round != self._round:
            self._round = int(round)
            self._round_sites = None
        if step is not None:
            self._step = int(step)

    def shift(self, x):
        return self._apply(x, self._inner.shift(x))

    def shift_back(self, x):
        return self._inner.shift_back(x)

    def fused_segment_sum(self, *args, **kwargs):
        return None  # force the separate hop so faults can inject

    def _apply(self, prev, shifted):
        sched = self.schedule
        if not sched.active:
            return shifted
        rnd = self._round if self._round is not None else 0
        step = self._step if self._step is not None else 0
        if self._round_sites is None:
            self._round_sites = sched._kinds_and_keys(
                rnd, np.arange(self.axis_size)[:, None],
                self._shards[None, :])
        kinds, (k0, k1) = self._round_sites
        kinds = kinds[step]
        if not kinds.any():
            return shifted
        out = shifted.clone()
        for row in np.flatnonzero(kinds).tolist():  # a shard held here
            kind = int(kinds[row])
            if kind == 1:
                out[row] = sched._corrupt(shifted[row], k0[step, row],
                                          k1[step, row])
            elif kind == 2:
                out[row] = 0
            else:
                out[row] = prev[row]
        return out


def record_faults(schedule: FaultSchedule, *, rounds: int, n_steps: int,
                  n_shards: int, round0: int = 0,
                  registry: Optional[telemetry.Registry] = None):
    """Count the faults a finished run's executed window hit into
    ``chaos_device_faults_total{kind}`` (a host replay of the schedule).
    Returns the per-kind counts."""
    counts = schedule.counts_between(round0, round0 + rounds, n_steps,
                                     n_shards)
    ctr = _faults_counter(registry)
    total = 0
    for kind in FAULT_KINDS:
        if counts[kind]:
            ctr.labels(kind).inc(counts[kind])
            total += counts[kind]
    if total and spans.current_tracer() is not None:
        spans.emit("device_faults", round0=round0, rounds=rounds, **counts)
        # Each fault site as its own point event, bounded so a dense
        # schedule cannot flood the span store.
        for rnd, step, shard, kind in schedule.sites_between(
                round0, round0 + rounds, n_steps, n_shards)[:64]:
            spans.emit("device_fault", round=rnd, step=step,
                       shard=shard, kind=kind)
    return counts


# ------------------------------------------------------- dispatch faults


class DispatchChaos:
    """One-shot dispatch faults at the engine/serve chunk boundary.

    ``preempt_at`` / ``wedge_at`` name 0-based dispatch indices (the
    process-wide count of gated dispatches while installed). When the
    gate reaches an armed index it raises :class:`ChipLost` /
    :class:`WedgedDispatch` before the dispatch touches any state and
    disarms that index, so a healing retry of the same chunk runs clean.
    Install with :func:`install_dispatch_chaos`; injections count into
    ``chaos_device_faults_total{kind="preempt"|"wedge"}``."""

    def __init__(self, *, preempt_at=(), wedge_at=(),
                 registry: Optional[telemetry.Registry] = None):
        self._lock = concurrency.lock()
        self._preempt = {int(i) for i in preempt_at}
        self._wedge = {int(i) for i in wedge_at}
        self._dispatches = 0
        self._ctr = _faults_counter(registry)

    @property
    def dispatches(self) -> int:
        with self._lock:
            return self._dispatches

    def on_dispatch(self, loop: str) -> None:
        kind = None
        with self._lock:
            n = self._dispatches
            self._dispatches += 1
            if n in self._preempt:
                self._preempt.discard(n)
                kind = "preempt"
            elif n in self._wedge:
                self._wedge.discard(n)
                kind = "wedge"
        if kind is None:
            return
        self._ctr.labels(kind).inc()
        if spans.current_tracer() is not None:
            spans.emit("dispatch_fault", kind=kind, loop=loop, index=n)
        if kind == "preempt":
            raise ChipLost(n)
        raise WedgedDispatch(n)


#: The installed dispatch-fault injector (None = off).
_dispatch_chaos: Optional[DispatchChaos] = None


def install_dispatch_chaos(dc: Optional[DispatchChaos]):
    """Install (or clear, with None) the process-wide dispatch-fault
    injector; returns the previous one so tests can restore it."""
    global _dispatch_chaos
    prev = _dispatch_chaos
    _dispatch_chaos = dc
    return prev


def dispatch_gate(loop: str) -> None:
    """The engines' chunk-dispatch hook: raise the armed fault, if any.
    One None check when nothing is installed."""
    dc = _dispatch_chaos
    if dc is not None:
        dc.on_dispatch(loop)
