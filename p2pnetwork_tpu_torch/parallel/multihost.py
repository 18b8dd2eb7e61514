"""Process bootstrap and rank meshes (torch counterpart of
``p2pnetwork_tpu/parallel/multihost.py``).

The reference runs one JAX process per host, rendezvoused by
``jax.distributed``, and lays its ring out host-major so that only the
hops that cross a host boundary leave the fast interconnect. Here each
process is a rank of a ``torch.distributed`` group (gloo: the group
carries only the rounds' small stats exchanges, and NCCL refuses two
ranks on one card), and the ring's hops between ranks are CUDA IPC peer
writes on the card (``ops/ring.py``, ``csrc/ring_peer.cu``) or gloo
sends on the CPU. The same code reaches a peer card over NVLink and a
peer process on the same card, so a machine with one card runs every
rank of a ring on it.

- :func:`initialize_distributed` joins the group (False for one process);
- :func:`hierarchical_ring_mesh` is the ring over every rank, host-major;
  rank ``r`` holds ``S / world`` consecutive shards (``mesh.shard_spec``);
- :func:`mesh_2d` is the ``[processes, shards a process]`` grid of the
  reference's 2-D mesh, for ``parallel/auto.py``;
- :func:`host_of` maps a rank to its host in a layout of ``per_host``
  ranks a host, which ``parallel/commviz.py::ring_hop_census`` classifies
  the ring's hops by;
- :func:`launch` starts ``world`` rank processes on this host and returns
  their results, failing (never hanging) when a rank fails or hangs.
"""

from __future__ import annotations

import dataclasses
import datetime
import importlib
import importlib.util
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from p2pnetwork_tpu_torch import _device, concurrency
from p2pnetwork_tpu_torch.parallel.mesh import DEFAULT_AXIS, RingMesh

#: Shards of a ring when the caller names no count: the reference's tests
#: and bench run an 8-device ring.
DEFAULT_SHARDS = 8

#: Seconds a collective may wait before the group gives up on a peer.
GROUP_TIMEOUT_S = 300
#: Bound on reaping a killed rank (SIGKILL ends it at once).
KILL_WAIT_S = 60.0


def _dist():
    import torch.distributed as dist

    return dist


def _world() -> Tuple[int, int]:
    """``(rank, world)`` of this process: ``(0, 1)`` outside a group."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Join the job's process group (gloo over TCP at
    ``coordinator_address``, ``host:port``). Arguments fall back to
    torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``). Returns True when running multi-process,
    False for the single-process case (no group: every code path runs
    unchanged)."""
    dist = _dist()
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if num_processes is None or num_processes <= 1:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError(
            f"a job of {num_processes} processes needs the coordinator's "
            f"address and this process's id (RANK)")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return dist.get_world_size() > 1


def _ranks_host_major() -> Tuple[int, ...]:
    """Every rank of the job ordered host-major: a host's ranks are
    consecutive, hosts in the order of their lowest rank, ranks in order
    within a host (the reference's ``(process_index, device id)``)."""
    rank, world = _world()
    if world == 1:
        return (0,)
    hosts = [None] * world
    _dist().all_gather_object(hosts, socket.gethostname())
    first = {}
    for r, h in enumerate(hosts):
        first.setdefault(h, r)
    return tuple(sorted(range(world), key=lambda r: (first[hosts[r]], r)))


def host_of(mesh: RingMesh, per_host: int):
    """``rank -> host index`` for a layout of ``per_host`` ranks a host,
    ``rank // per_host``: how the reference's
    ``examples/hierarchical_mesh_demo.py`` lays hosts over one machine
    (``d // PER_HOST``)."""
    if per_host < 1 or mesh.world % per_host:
        raise ValueError(f"{mesh.world} ranks do not split into hosts of "
                         f"{per_host}")
    return lambda r: int(r) // int(per_host)


def local_rank() -> int:
    """This process's index among its host's ranks (``LOCAL_RANK``, else
    the rank: every rank on one host)."""
    env = os.environ.get("LOCAL_RANK")
    return int(env) if env is not None else _world()[0]


def rank_device(device=None) -> torch.device:
    """The device of this rank: ``cuda:(local_rank % device_count)``
    unless the caller names one (``cpu``, or a card by index). With one
    card every rank takes ``cuda:0``."""
    dev = _device.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev


def hierarchical_ring_mesh(axis_name: str = DEFAULT_AXIS,
                           n_shards: Optional[int] = None,
                           device=None) -> RingMesh:
    """The ring over every rank of the job, host-major: with each host's
    ranks consecutive, only the hops between hosts leave a host. Rank
    ``r`` holds ``n_shards / world`` shards (default
    :data:`DEFAULT_SHARDS`), stacked on its :func:`rank_device`. In one
    process it is ``mesh.ring_mesh(n_shards)``."""
    rank, world = _world()
    n = DEFAULT_SHARDS if n_shards is None else int(n_shards)
    if n < world or n % world:
        raise ValueError(f"{n} shards do not split evenly over {world} "
                         f"ranks")
    return RingMesh(n_shards=n, axis_name=axis_name,
                    device=rank_device(device), rank=rank, world=world,
                    order=_ranks_host_major(),
                    group=_dist().group.WORLD if world > 1 else None)


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """The reference's ``[hosts, chips a host]`` mesh over the ring's
    shards: ``grid`` holds the global shard ids, a row a process (the
    reference counts a process as a host), on ``ring``'s device."""

    grid: np.ndarray
    axis_names: Tuple[str, str]
    ring: RingMesh

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.grid.shape)


def mesh_2d(axis_names: tuple = ("dcn", "ici"), hosts: Optional[int] = None,
            n_shards: Optional[int] = None, device=None) -> Mesh2D:
    """A ``[hosts, shards a host]`` grid over :func:`hierarchical_ring_mesh`'s
    shards. ``hosts`` overrides the process count (the reference's way to
    emulate a multi-slice layout in one process)."""
    ring = hierarchical_ring_mesh(n_shards=n_shards, device=device)
    n_hosts = ring.world if hosts is None else int(hosts)
    per_host = ring.n_shards // n_hosts
    if n_hosts * per_host != ring.n_shards:
        raise ValueError(f"uneven shard count: {ring.n_shards} shards over "
                         f"{n_hosts} hosts")
    grid = np.arange(ring.n_shards).reshape(n_hosts, per_host)
    return Mesh2D(grid=grid, axis_names=tuple(axis_names), ring=ring)


# ------------------------------------------------------------- the launcher

#: A rank's exit code when it could not join the group (the launcher
#: then retries once on a fresh port).
RENDEZVOUS_EXIT = 3


class RankError(RuntimeError):
    """A rank process failed; the message carries its traceback."""


def _free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(target: str, world: int, args: tuple = (), *,
           timeout: float = 300.0, device: str = "cpu") -> list:
    """Run ``target(*args)`` in ``world`` rank processes on this host,
    joined by a gloo group on a free loopback port, and return each
    rank's result (pickled back), in rank order.

    ``target`` is ``"module:function"`` or ``"path/to/file.py:function"``;
    the ranks import it and nothing else of the caller. With
    ``device="cuda"`` the kernels are built here first, so that the ranks
    load the built library and do not run ``world`` compilers. Every rank
    is joined with the time limit: when one fails or the limit passes,
    the others are killed and the failure is raised (:class:`RankError`
    with the rank's traceback, or ``TimeoutError``). A failed rendezvous
    is retried once on a new port."""
    if device != "cpu":
        from p2pnetwork_tpu_torch import _build

        _build.library()
    for retry in (True, False):
        with tempfile.TemporaryDirectory(prefix="p2p-ranks-") as out:
            with open(Path(out) / "args.pkl", "wb") as f:
                pickle.dump(args, f)
            if _run_ranks(target, world, out, timeout, retry):
                results = []
                for r in range(world):
                    with open(Path(out) / f"rank{r}.pkl", "rb") as f:
                        results.append(pickle.load(f))
                return results


def _rank_env(rank: int) -> dict:
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    env["LOCAL_RANK"] = str(rank)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("OMP_NUM_THREADS", "1")
    return env


def _run_ranks(target: str, world: int, out: str, timeout: float,
               retry: bool) -> bool:
    """Start the ranks and join them with the time limit: True when all
    finished, False when the ranks that failed all failed to join the
    group and ``retry`` allows another try. Raises on any other failure,
    after every rank has been stopped."""
    addr = f"127.0.0.1:{_free_port()}"
    procs = []
    for r in range(world):
        log = open(Path(out) / f"rank{r}.log", "wb")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "p2pnetwork_tpu_torch.parallel.multihost",
             target, str(r), str(world), addr, out],
            env=_rank_env(r), stdout=log, stderr=subprocess.STDOUT))
        log.close()
    deadline = time.monotonic() + timeout
    failed = []
    try:
        while True:
            for r, p in enumerate(procs):
                if r not in failed and p.poll() not in (None, 0):
                    failed.append(r)
            if failed or all(p.poll() == 0 for p in procs) \
                    or time.monotonic() > deadline:
                break
            concurrency.sleep(0.05)
    finally:
        alive = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=KILL_WAIT_S)
    if failed:
        if retry and all(procs[r].returncode == RENDEZVOUS_EXIT
                         for r in failed):
            return False
        # The first to fail is the cause; the others mostly failed on
        # the exchange it left.
        r = min(failed, key=lambda r: _failed_at(out, r))
        raise RankError(f"rank {r} of {world} failed (exit "
                        f"{procs[r].returncode}):\n{_rank_report(out, r)}")
    if alive:
        raise TimeoutError(f"ranks {alive} of {world} did not finish within "
                           f"{timeout} s; every rank was killed")
    return True


def _failed_at(out: str, rank: int) -> float:
    """When a failed rank wrote its traceback (its log's end without
    one)."""
    for name in (f"rank{rank}.err", f"rank{rank}.log"):
        path = Path(out) / name
        if path.exists():
            return path.stat().st_mtime
    return float("inf")


def _rank_report(out: str, rank: int) -> str:
    """A failed rank's traceback, else the end of its output."""
    for name in (f"rank{rank}.err", f"rank{rank}.log"):
        path = Path(out) / name
        if path.exists() and path.stat().st_size:
            return path.read_text(errors="replace")[-8000:]
    return "(no output)"


def _load_target(target: str):
    where, _, name = target.rpartition(":")
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            f"_rank_target_{Path(where).stem}", where)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def _rank_main(argv) -> int:
    """A rank process: join the group, run the target, pickle its result
    (``rank{r}.pkl``) or write its traceback (``rank{r}.err``)."""
    target, rank, world, addr, out = argv
    rank, world = int(rank), int(world)
    err = Path(out) / f"rank{rank}.err"
    try:
        initialize_distributed(addr, world, rank)
    except Exception:
        err.write_text(traceback.format_exc())
        return RENDEZVOUS_EXIT
    try:
        with open(Path(out) / "args.pkl", "rb") as f:
            args = pickle.load(f)
        result = _load_target(target)(*args)
        tmp = Path(out) / f"rank{rank}.pkl.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, Path(out) / f"rank{rank}.pkl")
    except BaseException:
        err.write_text(traceback.format_exc())
        return 1
    if _dist().is_initialized():  # a world of 1 joins no group
        _dist().destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1:]))
