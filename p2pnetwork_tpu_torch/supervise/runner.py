"""SupervisedRun: crash-tolerant chunked execution of the engine (the port's
counterpart of ``p2pnetwork_tpu/supervise/runner.py``).

The engine's run-to-* loops run a whole run in one call; a preemption or a
wedged dispatch mid-run loses everything since the last manual
``sim/checkpoint.py`` save. :class:`SupervisedRun` drives the same loops
(``engine.run_from`` / ``engine.run_until_coverage_from``) in round
chunks and owns what surrounds them:

- **auto-checkpoint** every N rounds or T seconds into a
  :class:`~p2pnetwork_tpu_torch.supervise.store.CheckpointStore`;
- **resume**: a run killed at any point restarts from the newest loadable
  entry and ends bit-identical to an uninterrupted supervised run;
- **watchdog**: a deadline thread fed heartbeats at chunk boundaries
  (``supervise/watchdog.py``);
- **deterministic preemption**: ``arm_preemption`` /
  ``sim.failures.preempt`` raise :class:`Preempted` at an exact round
  boundary, before the checkpoint due there.

Determinism contract (the reference's): chunk ``c`` starting at round
``s`` runs with the key ``prng.fold_in(base_key, s + 1)``, and chunk
boundaries are a pure function of (chunk_rounds, start round), so a
resumed run re-enters the uninterrupted run's boundary schedule with the
same chunk keys. Checkpoints and runs cross packages: a trail written by
either package's runner resumes in the other with the same state bits.

The port has no buffer donation, so a chunk never invalidates its input:
the input of a checkpoint-feeding chunk is kept as the emergency
fallback (:meth:`SupervisedRun.emergency_checkpoint`), as the reference
keeps its undonated input. ``heal=`` (a ``supervise/heal.py``
``RetryPolicy``) runs every chunk under a ``Healer``: a detected fault
rolls the chunk back to its retained input and re-runs it with the same
chunk key, so the healed run is bit-identical to an undisturbed one.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Union

from p2pnetwork_tpu_torch import concurrency, prng, telemetry
from p2pnetwork_tpu_torch.sim import engine
from p2pnetwork_tpu_torch.supervise.store import CheckpointStore
from p2pnetwork_tpu_torch.supervise.watchdog import Watchdog
from p2pnetwork_tpu_torch.telemetry import spans

__all__ = ["SupervisedRun", "Preempted"]


class Preempted(RuntimeError):
    """The harness was deterministically killed at a round boundary
    (``failures.preempt`` / ``arm_preemption``). Revive by calling the
    same ``run_*`` entry again: it resumes from the last durable
    checkpoint, never from this exception's in-memory state."""

    def __init__(self, round_index: int):
        self.round_index = round_index
        super().__init__(
            f"supervised run preempted at round {round_index} "
            f"(resume from the checkpoint store to revive)")


class SupervisedRun:
    """Crash-tolerant harness over ``engine.run_from`` /
    ``engine.run_until_coverage_from``, with the reference's constructor.

    ``store`` is a :class:`CheckpointStore` or a directory path (a store
    with ``retain`` entries is made there); ``chunk_rounds`` the rounds
    per engine call; ``checkpoint_every_rounds`` / ``checkpoint_every_s``
    the cadence, whichever fires first at a chunk boundary (every chunk
    when neither is set); ``deadline_s`` / ``on_stall`` the watchdog
    (``None`` disables it); ``on_chunk(run, info)`` fires after every
    chunk with ``{"round", "executed", "coverage", "checkpointed",
    "heal"}``. ``heal`` (a ``RetryPolicy`` of ``supervise/heal.py``) runs
    every chunk under a ``Healer`` (module doc); the chunk's attempt
    history is ``info["heal"]``."""

    def __init__(self, graph, protocol,
                 store: Union[CheckpointStore, str], *,
                 chunk_rounds: int = 32,
                 checkpoint_every_rounds: Optional[int] = None,
                 checkpoint_every_s: Optional[float] = None,
                 retain: int = 3,
                 deadline_s: Optional[float] = None,
                 on_stall: Union[str, Callable] = "raise",
                 heal=None,
                 on_chunk: Optional[Callable] = None,
                 registry: Optional[telemetry.Registry] = None):
        if chunk_rounds < 1:
            raise ValueError("chunk_rounds must be >= 1")
        if checkpoint_every_rounds is not None and checkpoint_every_rounds < 1:
            raise ValueError("checkpoint_every_rounds must be >= 1")
        self.graph = graph
        self.protocol = protocol
        self.store = store if isinstance(store, CheckpointStore) \
            else CheckpointStore(store, retain=retain, registry=registry)
        self.chunk_rounds = int(chunk_rounds)
        if checkpoint_every_rounds is None and checkpoint_every_s is None:
            checkpoint_every_rounds = self.chunk_rounds
        self.checkpoint_every_rounds = checkpoint_every_rounds
        self.checkpoint_every_s = checkpoint_every_s
        self.deadline_s = deadline_s
        self.on_stall = on_stall
        self.heal = heal
        self.on_chunk = on_chunk
        self._registry = registry
        reg = registry if registry is not None else telemetry.default_registry()
        self._m_chunks = reg.counter(
            "supervise_chunks_total",
            "Device-dispatch chunks executed by supervised runs.")
        self._m_runs = reg.counter(
            "supervise_runs_total",
            "Supervised run invocations, by outcome.", ("outcome",))
        self._m_resumes = reg.counter(
            "supervise_resumes_total",
            "Supervised runs that restored state from the checkpoint store "
            "instead of a fresh protocol init.")
        self._preempt_at: Optional[int] = None
        # The input of a checkpoint-feeding chunk, published for the
        # duration of its dispatch; read by emergency_checkpoint from the
        # watchdog's thread while the run thread swaps it.
        self._fb_lock = concurrency.lock()
        self._fallback: Optional[tuple] = None

    def arm_preemption(self, at_round: int) -> None:
        """Arm a one-shot deterministic kill: the chunk loop raises
        :class:`Preempted` at the first chunk boundary at or past
        ``at_round``, before taking any checkpoint due there."""
        self._preempt_at = int(at_round)

    def emergency_checkpoint(self) -> Optional[str]:
        """Persist the current fallback state, if one is published (safe
        from any thread, e.g. an ``on_stall`` hook); ``None`` otherwise."""
        with self._fb_lock:
            fb = self._fallback
        if fb is None:
            return None
        state, base_key, rnd, msgs = fb
        return self.store.save(state, base_key, rnd, msgs)

    def _set_fallback(self, fb: Optional[tuple]) -> None:
        with self._fb_lock:
            self._fallback = fb

    def run_until_coverage(self, key, *, coverage_target: float = 0.99,
                           max_rounds: int = 1024, steps_per_round: int = 1,
                           resume: bool = True) -> tuple:
        """Supervised ``engine.run_until_coverage_from``: chunked,
        auto-checkpointed, resumable. Returns ``(state, summary)`` with
        ``rounds`` (cumulative, resumed rounds included), ``coverage``,
        exact ``messages``, ``chunks``, ``checkpoints``, ``resumed_from``,
        ``checkpoint_path`` and ``stalls``. ``key`` seeds a fresh run
        only: on resume the checkpoint's base key continues the chain. A
        fresh start into a directory holding a previous trail clears
        it."""
        return self._drive("coverage", key, max_rounds,
                           coverage_target=coverage_target,
                           steps_per_round=steps_per_round, resume=resume)

    def run_rounds(self, key, rounds: int, *, resume: bool = True) -> tuple:
        """Supervised ``engine.run_from``: ``rounds`` rounds in all
        (checkpointed progress counts on resume). Returns ``(state,
        summary)``."""
        return self._drive("rounds", key, rounds, resume=resume)

    def _restore_or_init(self, key, resume: bool):
        # The template is a real init on the run's device (the reference
        # shapes it with jax.eval_shape); grow=True lets a trail written
        # before a Graph.grow repad zero-extend into it.
        template = self.protocol.init(self.graph, key)
        restored = self.store.load_latest(template, grow=True) \
            if resume else None
        if restored is not None:
            state, base_key, rnd, msgs, _path = restored
            self._m_resumes.inc()
            return state, base_key, int(rnd), int(msgs), int(rnd)
        if self.store.entries():
            self.store.clear()
        return template, key, 0, 0, None

    def _ckpt_due(self, rounds_since: int, t_last: float) -> bool:
        if self.checkpoint_every_rounds is not None \
                and rounds_since >= self.checkpoint_every_rounds:
            return True
        if self.checkpoint_every_s is not None \
                and time.monotonic() - t_last >= self.checkpoint_every_s:
            return True
        return False

    def _drive(self, mode: str, key, total_target: int, *,
               coverage_target: float = 0.99, steps_per_round: int = 1,
               resume: bool = True) -> tuple:
        with spans.span("supervised_run", mode=mode):
            return self._drive_under_span(
                mode, key, total_target, coverage_target=coverage_target,
                steps_per_round=steps_per_round, resume=resume)

    def _dispatch(self, mode, chunk_key, chunk, coverage_target,
                  steps_per_round):
        """One engine call as ``state -> (state, out)``."""
        if mode == "coverage":
            return lambda s: engine.run_until_coverage_from(
                self.graph, self.protocol, s, chunk_key,
                coverage_target=coverage_target, max_rounds=chunk,
                steps_per_round=steps_per_round)
        return lambda s: engine.run_from(self.graph, self.protocol, s,
                                         chunk_key, chunk)

    @staticmethod
    def _tally(mode, out, chunk):
        """``(executed, messages, coverage)`` of one engine call."""
        if mode == "coverage":
            return (int(out["rounds"]), int(out["messages"]),
                    float(out["coverage"]))
        msgs = int(out["messages"].sum()) if "messages" in out else 0
        return chunk, msgs, None

    def _drive_under_span(self, mode: str, key, total_target: int, *,
                          coverage_target: float = 0.99,
                          steps_per_round: int = 1,
                          resume: bool = True) -> tuple:
        state, base_key, total, messages, resumed_from = \
            self._restore_or_init(key, resume)
        if resumed_from is not None:
            spans.emit("resume", round=total)
        last_ckpt_round, t_last_ckpt = total, time.monotonic()
        coverage = None
        chunks = n_ckpts = 0
        last_path = None
        outcome = "completed"
        watchdog = None
        if self.deadline_s is not None:
            watchdog = Watchdog(self.deadline_s, name=f"supervised-{mode}",
                                on_stall=self.on_stall,
                                registry=self._registry).start()
        healer = None
        if self.heal is not None:
            from p2pnetwork_tpu_torch.supervise.heal import Healer

            # Rollback authority is the retained chunk input, never the
            # store: the store's newest entry can be an older boundary,
            # and re-executing one chunk from an older round would
            # corrupt the round accounting this loop owns.
            healer = Healer(self.heal, registry=self._registry)
        try:
            while total < total_target:
                chunk = min(self.chunk_rounds, total_target - total)
                ckpt_feeding = self._ckpt_due(
                    total + chunk - last_ckpt_round, t_last_ckpt) \
                    or (total + chunk >= total_target)
                chunk_key = prng.fold_in(base_key, total + 1)
                if watchdog is not None:
                    watchdog.heartbeat()
                if ckpt_feeding:
                    self._set_fallback((state, base_key, total, messages))
                try:
                    dispatch = self._dispatch(mode, chunk_key, chunk,
                                              coverage_target,
                                              steps_per_round)
                    if healer is not None:
                        state, out = healer.run_chunk(dispatch, state,
                                                      chunk_index=chunks)
                    else:
                        state, out = dispatch(state)
                    executed, msgs, cov = self._tally(mode, out, chunk)
                except BaseException:
                    # The dispatch died mid-chunk: make a boundary chunk's
                    # input durable before unwinding.
                    try:
                        self.emergency_checkpoint()
                    except Exception:
                        pass  # a failing save must not mask the error
                    raise
                finally:
                    self._set_fallback(None)
                messages += msgs
                if cov is not None:
                    coverage = cov
                if watchdog is not None:
                    watchdog.heartbeat()
                total += executed
                chunks += 1
                self._m_chunks.inc()
                done = (total >= total_target or
                        (mode == "coverage" and
                         (executed == 0 or
                          (coverage is not None
                           and coverage >= coverage_target))))
                if self._preempt_at is not None \
                        and total >= self._preempt_at:
                    # Fires before the checkpoint due at this boundary,
                    # as a real kill would.
                    self._preempt_at = None
                    outcome = "preempted"
                    raise Preempted(total)
                checkpointed = False
                if done or self._ckpt_due(total - last_ckpt_round,
                                          t_last_ckpt):
                    last_path = self.store.save(
                        state, base_key, total, messages)
                    last_ckpt_round, t_last_ckpt = total, time.monotonic()
                    n_ckpts += 1
                    checkpointed = True
                    spans.emit("checkpoint", round=total, path=last_path)
                spans.emit("chunk", round=total, executed=executed,
                           checkpointed=checkpointed)
                # A chunk that needed healing leaves its attempt history
                # on the healer: surfaced next to the chunk event and to
                # the on_chunk observer.
                heal_report = None if healer is None else healer.last_report
                if heal_report is not None and heal_report["events"]:
                    spans.emit("heal_report", round=total,
                               chunk=heal_report["chunk"],
                               attempts=heal_report["attempts"],
                               healed=heal_report["healed"],
                               fallback=heal_report["fallback"])
                if self.on_chunk is not None:
                    self.on_chunk(self, {
                        "round": total, "executed": executed,
                        "coverage": coverage, "checkpointed": checkpointed,
                        "heal": heal_report,
                    })
                if done:
                    break
        except Preempted:
            raise
        except BaseException:
            outcome = "error"
            raise
        finally:
            if watchdog is not None:
                watchdog.close()
            self._m_runs.labels(outcome).inc()
        summary: Dict[str, Any] = {
            "rounds": total, "messages": messages, "chunks": chunks,
            "checkpoints": n_ckpts, "resumed_from": resumed_from,
            "checkpoint_path": last_path,
            "stalls": watchdog.stalls if watchdog is not None else 0,
        }
        if coverage is not None:
            summary["coverage"] = coverage
        return state, summary
