"""Build the port's CUDA kernels at first use.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together), then linked into one shared library with a
plain C interface, loaded with ``ctypes``. The library goes to ``_build/``
beside this file (git-ignored), named by a hash of the sources and flags, so
a changed source rebuilds and an unchanged one loads what is there.

Nothing happens at import: the CPU tests import every module on machines
without ``nvcc``. The first CUDA call of a kernel wrapper builds.

One caller builds, outside the module lock; callers that arrive meanwhile
wait for it (bounded by ``BUILD_WAIT_S``) and raise if it failed. Every
``nvcc`` wait is bounded by ``NVCC_TIMEOUT_S``: a compiler that hangs
raises, naming its source, and never falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from contextlib import suppress
from pathlib import Path
from typing import Optional

from p2pnetwork_tpu_torch import concurrency

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
OUT_DIR = _PKG / "_build"

#: ``sm_90a`` keeps Hopper's wgmma/setmaxnreg available to later kernels.
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: libcuda, for ``cuStreamWaitValue32`` (``csrc/ring_peer.cu``).
LDFLAGS = ["-lcuda"]

#: Bound on one ``nvcc`` compile or link (a source builds in seconds).
NVCC_TIMEOUT_S = 600.0
#: Bound on a caller's wait for another thread's build.
BUILD_WAIT_S = 1800.0

_lock = concurrency.lock()
_lib = None
_building = None

#: What the last build did: library path, seconds, whether it compiled,
#: and the compiler's output (``-Xptxas -v``: registers, shared memory).
LAST_BUILD: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the port's CUDA kernels")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(CFLAGS + LDFLAGS).encode())
    for src in sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _finish(proc: subprocess.Popen, name: str) -> str:
    """The output of one ``nvcc`` compile of ``name``; raises if it fails
    or does not finish within ``NVCC_TIMEOUT_S``."""
    try:
        out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"nvcc did not finish {name} within "
                           f"{NVCC_TIMEOUT_S:g} s") from None
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{out}")
    return out


def _compile(target: Path) -> str:
    """Compile every source in parallel and link ``target``; returns the
    compiler output. Raises with that output on failure."""
    nvcc = _nvcc()
    sources = sorted(SRC_DIR.glob("*.cu"))
    OUT_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *CFLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        log = []
        try:
            for src, proc in zip(sources, procs):
                log.append(f"[{src.name}]\n{_finish(proc, src.name)}")
        finally:
            for other in procs:
                if other.poll() is None:
                    other.kill()
                    with suppress(subprocess.TimeoutExpired):
                        other.wait(timeout=NVCC_TIMEOUT_S)
        lib_tmp = Path(tmp) / target.name
        try:
            link = subprocess.run(
                [nvcc, *ARCH, "-shared", *map(str, objs), "-o",
                 str(lib_tmp), *LDFLAGS],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"nvcc did not link {target.name} within "
                               f"{NVCC_TIMEOUT_S:g} s") from None
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        # Rename into place: a concurrent loader never sees half a file.
        os.replace(lib_tmp, target)
    return "\n".join(log)


class _Build:
    """One build in flight: callers that find it wait on ``done``."""

    def __init__(self):
        self.done = concurrency.event()
        self.error: Optional[BaseException] = None


def _load() -> ctypes.CDLL:
    """Build the library if its digest has none yet, then load it."""
    t0 = time.perf_counter()
    target = OUT_DIR / f"libp2p_kernels-{_digest()}.so"
    compiled = not target.exists()
    log = _compile(target) if compiled else ""
    lib = ctypes.CDLL(str(target))
    LAST_BUILD.update(path=str(target), compiled=compiled, log=log,
                      seconds=time.perf_counter() - t0)
    return lib


def library() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once."""
    global _lib, _building
    with _lock:
        lib, build = _lib, _building
        mine = lib is None and build is None
        if mine:
            build = _building = _Build()
    if lib is not None:
        return lib
    if not mine:
        if not build.done.wait(BUILD_WAIT_S):
            raise RuntimeError("the kernel library's build by another "
                               f"thread did not finish within "
                               f"{BUILD_WAIT_S:g} s")
        if build.error is not None:
            raise RuntimeError("the kernel library's build failed") \
                from build.error
        with _lock:
            return _lib
    try:
        lib = _load()
    except BaseException as e:
        build.error = e
        raise
    else:
        with _lock:
            _lib = lib
        return lib
    finally:
        with _lock:
            _building = None
        build.done.set()
