"""Build the port's CUDA kernels at first use.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together), then linked into one shared library with a
plain C interface, loaded with ``ctypes``. The library goes to ``_build/``
beside this file (git-ignored), named by a hash of the sources and flags, so
a changed source rebuilds and an unchanged one loads what is there.

Nothing happens at import: the CPU tests import every module on machines
without ``nvcc``. The first CUDA call of a kernel wrapper builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
OUT_DIR = _PKG / "_build"

#: ``sm_90a`` keeps Hopper's wgmma/setmaxnreg available to later kernels.
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: libcuda, for ``cuStreamWaitValue32`` (``csrc/ring_peer.cu``).
LDFLAGS = ["-lcuda"]

_lock = threading.Lock()
_lib = None

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
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            log.append(f"[{src.name}]\n{out}")
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        lib_tmp = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", *map(str, objs), "-o", str(lib_tmp),
             *LDFLAGS],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        # Rename into place: a concurrent loader never sees half a file.
        os.replace(lib_tmp, target)
    return "\n".join(log)


def library() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once."""
    global _lib
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            target = OUT_DIR / f"libp2p_kernels-{_digest()}.so"
            compiled = not target.exists()
            log = _compile(target) if compiled else ""
            _lib = ctypes.CDLL(str(target))
            LAST_BUILD.update(path=str(target), compiled=compiled, log=log,
                              seconds=time.perf_counter() - t0)
        return _lib
