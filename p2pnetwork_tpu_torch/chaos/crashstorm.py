"""Crash-storm campaign: seeded SIGKILLs against the serving trail,
asserting zero acknowledged-ticket loss (the port's copy of
``p2pnetwork_tpu/chaos/crashstorm.py``; the same schedules, seams and
report).

A :class:`CrashSchedule` is a byte-replayable list of kill points drawn
from one stdlib ``random.Random(seed)`` stream. Each kill names a seam
the service plants for it:

- ``"tick"`` — die mid-tick: after the engine dispatch, before harvest
  (``SimService._tick_fault``), so the journal holds acks the boundary
  pair does not;
- ``"sidecar_publish"`` — die inside the checkpoint, between the store
  entry landing and the sidecar rename (``_publish_fault``);
- ``"journal_append"`` — die between a record's header and payload
  writes (the journal's ``fault_hook`` at ``"append_mid"``), leaving a
  torn tail the next life must truncate past;
- ``"disk_full"`` — same seam, but raise ``ENOSPC`` instead of dying:
  the service must flip to ``DurabilityLost`` shedding.

:func:`run_campaign` drives the storm as a subprocess soak: one
reference child runs a seeded traffic + grow-only churn workload
uninterrupted; K children run the same workload over a shared trail,
each dying at its scheduled kill (``SIGKILL``: no atexit, no flush); a
final child runs the workload to completion over the survivors' trail.
After every kill the parent scans the dead child's trail with
:func:`acked_tickets` (sidecar JSON plus the journal suffix past its
``journal_seqno``); the campaign fails unless every ticket ever seen
acknowledged is in the final table, and the final table (status,
rounds, seen hashes) equals the uninterrupted reference's.

The children import torch and the port and run on the CUDA card unless
the campaign's config says ``"device": "cpu"``; with no card and no such
config a child fails. Churn is grow-only: edge deltas mutate the
overlay beyond what the sidecar's growth steps can replay onto a fresh
construction, so a delta-churned trail refuses resume
(``GraphMismatch``). ``disk_full`` is not a campaign kill (it degrades
availability, so the final table legitimately differs); it is
installable via :func:`install` for in-process tests. The parent itself
never touches a device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import signal
import subprocess
import sys
from typing import Callable, Dict, List, Optional, Set, Tuple

from p2pnetwork_tpu_torch.serve.journal import read_records

__all__ = ["KILL_KINDS", "KillPoint", "CrashSchedule", "CampaignError",
           "generate", "install", "acked_tickets", "run_campaign",
           "DEFAULT_CONFIG"]

#: Kill seams a :class:`KillPoint` can name (module doc).
KILL_KINDS = ("tick", "journal_append", "sidecar_publish", "disk_full")

# Keep in sync with serve.service._SIDECAR (not imported: that module
# pulls torch, and the campaign parent stays device-free).
_SIDECAR = "service_state.json"

_REPO = os.path.abspath(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "..", ".."))


class CampaignError(RuntimeError):
    """The crash-storm campaign's contract was violated: an
    acknowledged ticket vanished, the final table diverged from the
    uninterrupted reference, or a child failed outside its kill."""


@dataclasses.dataclass(frozen=True)
class KillPoint:
    """One scheduled kill. ``at`` is the trigger ordinal: for
    ``"tick"`` / ``"sidecar_publish"`` the first driver tick index at
    or past which the seam fires; for ``"journal_append"`` /
    ``"disk_full"`` the Nth (1-based) record append of the child's
    life."""

    kind: str
    at: int

    def __post_init__(self):
        if self.kind not in KILL_KINDS:
            raise ValueError(f"kill kind {self.kind!r} not in {KILL_KINDS}")
        if self.at < 1:
            raise ValueError("kill point `at` must be >= 1")


@dataclasses.dataclass(frozen=True)
class CrashSchedule:
    """A materialized kill schedule plus the seed that drew it."""

    kills: Tuple[KillPoint, ...]
    seed: int

    def __len__(self) -> int:
        return len(self.kills)

    def to_bytes(self) -> bytes:
        """Canonical serialization — the byte-identity witness the
        determinism test compares (two generations must match)."""
        return json.dumps({
            "seed": self.seed,
            "kills": [dataclasses.asdict(k) for k in self.kills],
        }, sort_keys=True, separators=(",", ":")).encode("utf-8")


def generate(n_kills: int, *, seed: int = 0, ticks: int = 32,
             require: Tuple[str, ...] = ("journal_append",
                                         "sidecar_publish")) -> CrashSchedule:
    """Draw a :class:`CrashSchedule` of ``n_kills`` SIGKILL points off
    one ``random.Random(seed)`` stream (byte-replayable). ``require``
    kinds are guaranteed present (the acceptance soak needs at least
    one mid-journal-append and one mid-sidecar-publish kill); the rest
    are drawn uniformly from the SIGKILL kinds. Tick-keyed kills get
    increasing trigger ticks spread across the ``ticks``-long schedule
    so successive lives keep making progress; append-keyed kills
    trigger early in their life (a torn tail needs appends, not
    ticks)."""
    if n_kills < 1:
        raise ValueError("n_kills must be >= 1")
    for kind in require:
        if kind not in KILL_KINDS or kind == "disk_full":
            raise ValueError(
                f"require kind {kind!r} must be a SIGKILL kind "
                f"(one of {tuple(k for k in KILL_KINDS if k != 'disk_full')})")
    if n_kills < len(require):
        raise ValueError(
            f"n_kills={n_kills} cannot cover required kinds {require}")
    rng = random.Random(int(seed))
    pool = [k for k in KILL_KINDS if k != "disk_full"]
    kinds: List[str] = list(require)
    kinds += [pool[rng.randrange(len(pool))]
              for _ in range(n_kills - len(require))]
    rng.shuffle(kinds)
    kills: List[Optional[KillPoint]] = [None] * len(kinds)
    tick_slots = [i for i, k in enumerate(kinds)
                  if k in ("tick", "sidecar_publish")]
    lo, hi = 2, max(3, int(ticks) - 2)
    span = max(1, (hi - lo) // max(1, len(tick_slots)))
    for j, i in enumerate(tick_slots):
        at = min(hi, lo + j * span + rng.randrange(span))
        kills[i] = KillPoint(kinds[i], at)
    for i, kind in enumerate(kinds):
        if kills[i] is None:
            kills[i] = KillPoint(kind, rng.randrange(2, 12))
    return CrashSchedule(kills=tuple(kills), seed=int(seed))


# ------------------------------------------------------------- injection

def install(service, kill: KillPoint, *,
            action: Optional[Callable[[], None]] = None) -> Callable[[], None]:
    """Arm one kill point on a live (not yet driven) service.

    ``action`` defaults to ``os.kill(os.getpid(), SIGKILL)`` for the
    SIGKILL kinds — the real thing, no atexit, no buffered goodbye —
    and to raising ``OSError(ENOSPC)`` for ``"disk_full"``. In-process
    tests pass their own action (e.g. raising a simulated-kill
    exception) to exercise the same seams without losing the process.
    Returns the action installed (for introspection)."""
    kind, at = kill.kind, int(kill.at)
    if action is None:
        if kind == "disk_full":
            def action() -> None:
                raise OSError(28, "No space left on device (injected)")
        else:
            def action() -> None:
                os.kill(os.getpid(), signal.SIGKILL)
    if kind == "tick":
        def tick_fault(tick0: int) -> None:
            if int(tick0) >= at:
                action()
        service._tick_fault = tick_fault
    elif kind == "sidecar_publish":
        def publish_fault(tick: int) -> None:
            if int(tick) >= at:
                action()
        service._publish_fault = publish_fault
    else:  # journal_append / disk_full: Nth append of this life
        journal = service._journal
        if journal is None:
            raise ValueError(
                f"kill kind {kind!r} needs a journaled service "
                "(construct with store=... and journal enabled)")
        seen = {"n": 0}

        def hook(event: str, seq: int) -> None:
            if event != "append_mid":
                return
            seen["n"] += 1
            if seen["n"] >= at:
                action()
        journal.fault_hook = hook
    return action


# ------------------------------------------------------------ trail scan

def acked_tickets(directory: str) -> Set[str]:
    """Every ticket id the trail at ``directory`` proves was
    acknowledged: the sidecar's ticket table plus journaled submits
    past the sidecar's ``journal_seqno``. Pure stdlib reads — safe on
    a freshly killed child's trail, creates nothing."""
    side: dict = {}
    try:
        with open(os.path.join(directory, _SIDECAR),
                  "r", encoding="utf-8") as f:
            loaded = json.load(f)
        if isinstance(loaded, dict):
            side = loaded
    except (OSError, ValueError):
        pass
    acked = {str(t) for t in (side.get("tickets") or {})}
    covered = int(side.get("journal_seqno", 0) or 0)
    records, _ = read_records(directory)
    for rec in records:
        if rec.get("kind") == "submit" and int(rec["seq"]) > covered:
            acked.add(str(rec["ticket"]))
    return acked


# -------------------------------------------------------- subprocess soak

#: The campaign workload (child-side construction; everything a pure
#: function of these values, so every child builds the identical run).
DEFAULT_CONFIG: Dict[str, object] = {
    "n_nodes": 512, "degree": 6, "rewire": 0.1, "graph_seed": 3,
    "ticks": 24, "rate": 2.0, "traffic_seed": 11,
    "grow_prob": 0.2, "grow_batch": 8, "churn_seed": 7,
    "capacity": 16, "chunk_rounds": 4, "service_seed": 0,
    "checkpoint_every_ticks": 4,
}

_CHILD = '''
import json, sys

sys.path.insert(0, {repo!r})
import torch  # noqa: F401  (fail fast if the runtime is absent)

from p2pnetwork_tpu_torch.chaos import crashstorm
from p2pnetwork_tpu_torch.chaos import storm as storm_mod
from p2pnetwork_tpu_torch.serve import SimService
from p2pnetwork_tpu_torch.serve import traffic as traffic_mod
from p2pnetwork_tpu_torch.sim import graph as G

cfg_path, store_dir, kill_kind, kill_at = sys.argv[1:5]
with open(cfg_path, "r", encoding="utf-8") as f:
    cfg = json.load(f)

# The CUDA card unless the config names another device; the graph
# builder raises when the card is absent.
g = G.watts_strogatz(int(cfg["n_nodes"]), int(cfg["degree"]),
                     float(cfg["rewire"]), seed=int(cfg["graph_seed"]),
                     device=cfg.get("device"))
tp = traffic_mod.TrafficPattern(ticks=int(cfg["ticks"]),
                                rate=float(cfg["rate"]))
ts = traffic_mod.generate(tp, int(cfg["n_nodes"]),
                          seed=int(cfg["traffic_seed"]))
# GROW-ONLY churn: edge deltas would gate resume (GraphMismatch) —
# crashstorm module doc.
cp = storm_mod.ChurnPattern(ticks=int(cfg["ticks"]), join_prob=0.0,
                            leave_prob=0.0,
                            grow_prob=float(cfg["grow_prob"]),
                            grow_batch=int(cfg["grow_batch"]))
cs = storm_mod.generate(cp, int(cfg["n_nodes"]),
                        seed=int(cfg["churn_seed"]))
svc = SimService(g, capacity=int(cfg["capacity"]),
                 chunk_rounds=int(cfg["chunk_rounds"]),
                 seed=int(cfg["service_seed"]), store=store_dir,
                 checkpoint_every_ticks=int(
                     cfg["checkpoint_every_ticks"]),
                 record_seen_hash=True)
if kill_kind != "none":
    crashstorm.install(
        svc, crashstorm.KillPoint(kill_kind, int(kill_at)))
res = storm_mod.drive(svc, cs, traffic=ts)
table = svc.tickets()
svc.close()
print("DONE " + json.dumps(
    {{"tickets": table, "submitted": res["submitted"],
      "replayed": res["replayed"], "shed": len(res["shed"])}},
    sort_keys=True), flush=True)
'''


def _run_child(script: str, cfg_path: str, store_dir: str, kind: str,
               at: int, *, timeout: float,
               env: Optional[Dict[str, str]]) -> subprocess.CompletedProcess:
    child_env = dict(os.environ)
    if env:
        child_env.update(env)
    return subprocess.run(
        [sys.executable, script, cfg_path, str(store_dir),
         str(kind), str(int(at))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=_REPO, env=child_env, timeout=timeout)


def _parse_done(proc: subprocess.CompletedProcess, what: str) -> dict:
    if proc.returncode != 0:
        raise CampaignError(
            f"{what} child exited {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    for line in proc.stdout.splitlines():
        if line.startswith("DONE "):
            return json.loads(line[len("DONE "):])
    raise CampaignError(f"{what} child printed no DONE line: "
                        f"{proc.stdout[-2000:]}")


def run_campaign(workdir: str, schedule: CrashSchedule, *,
                 config: Optional[Dict[str, object]] = None,
                 timeout: float = 900.0,
                 env: Optional[Dict[str, str]] = None) -> dict:
    """Run the subprocess crash-storm soak (module doc) under
    ``workdir``; raises :class:`CampaignError` on any acknowledged-
    ticket loss or reference divergence, else returns the report::

        {"kills": [{"kind", "at", "landed", "acked"}...],
         "acked_seen", "tickets", "replayed", "reference_submitted"}

    ``landed`` is False when a child finished its whole workload before
    the kill point fired (a too-fast box) — tolerated, the other kills
    still exercise their seams. ``env`` entries overlay ``os.environ``
    for the children; ``config["device"]`` (default: the CUDA card)
    places their graph and service."""
    for kill in schedule.kills:
        if kill.kind == "disk_full":
            raise CampaignError(
                "disk_full is an availability fault, not a kill: the "
                "degraded life sheds arrivals loudly while its trail "
                "advances, so the final table legitimately diverges "
                "from the reference — drive it in-process instead "
                "(install() with its own action)")
    cfg = dict(DEFAULT_CONFIG)
    cfg.update(config or {})
    workdir = os.path.abspath(workdir)
    os.makedirs(workdir, exist_ok=True)
    script = os.path.join(workdir, "crashstorm_child.py")
    with open(script, "w", encoding="utf-8") as f:
        f.write(_CHILD.format(repo=_REPO))
    cfg_path = os.path.join(workdir, "crashstorm_config.json")
    with open(cfg_path, "w", encoding="utf-8") as f:
        json.dump(cfg, f, sort_keys=True)
    ref_dir = os.path.join(workdir, "reference")
    trail_dir = os.path.join(workdir, "trail")

    ref = _parse_done(
        _run_child(script, cfg_path, ref_dir, "none", 0,
                   timeout=timeout, env=env), "reference")

    acked_seen: Set[str] = set()
    kills_report: List[dict] = []
    for kill in schedule.kills:
        proc = _run_child(script, cfg_path, trail_dir, kill.kind,
                          kill.at, timeout=timeout, env=env)
        landed = proc.returncode == -signal.SIGKILL
        if not landed and proc.returncode != 0:
            raise CampaignError(
                f"kill child ({kill.kind}@{kill.at}) exited "
                f"{proc.returncode} (expected -SIGKILL or clean "
                f"finish): {proc.stderr[-2000:]}")
        acked = acked_tickets(trail_dir)
        acked_seen |= acked
        kills_report.append({"kind": kill.kind, "at": kill.at,
                             "landed": landed, "acked": len(acked)})

    final = _parse_done(
        _run_child(script, cfg_path, trail_dir, "none", 0,
                   timeout=timeout, env=env), "final")

    lost = sorted(acked_seen - set(final["tickets"]))
    if lost:
        raise CampaignError(
            f"acknowledged tickets lost across the storm: {lost[:10]}"
            f"{'...' if len(lost) > 10 else ''} "
            f"({len(lost)} of {len(acked_seen)} acked)")
    if final["tickets"] != ref["tickets"]:
        ref_t, fin_t = ref["tickets"], final["tickets"]
        only_ref = sorted(set(ref_t) - set(fin_t))
        only_fin = sorted(set(fin_t) - set(ref_t))
        differing = sorted(t for t in set(ref_t) & set(fin_t)
                           if ref_t[t] != fin_t[t])
        raise CampaignError(
            "final table diverged from the uninterrupted reference: "
            f"missing={only_ref[:5]} extra={only_fin[:5]} "
            f"differing={differing[:5]} "
            f"(first diff: {differing[0] if differing else None} "
            f"ref={ref_t[differing[0]] if differing else None} "
            f"got={fin_t[differing[0]] if differing else None})")
    return {"kills": kills_report, "acked_seen": len(acked_seen),
            "tickets": len(final["tickets"]),
            "replayed": int(final["replayed"]),
            "reference_submitted": int(ref["submitted"])}
