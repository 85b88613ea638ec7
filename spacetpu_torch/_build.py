"""Build of the CUDA sources in ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ctypes. The sources include
no PyTorch headers, so a build takes seconds. A library is keyed by a hash
of the sources and the flags and is written into ``_build/`` beside this
file; nothing is built until the first call on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: per library name: {"path", "seconds" (0.0 when an earlier build was
#: reused), "log" (nvcc's output, with ptxas' register and spill counts)}
BUILD_INFO: dict[str, dict] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    return os.path.join(home or "/usr/local/cuda", "bin", "nvcc")


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> None:
    """Build the named libraries that are not built yet, one nvcc process
    each, all started together. Raises RuntimeError with nvcc's output when
    a build fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = []
    for name in names:
        target = _target(name)
        log = target.with_suffix(".log")
        if target.exists():
            BUILD_INFO[name] = dict(
                path=str(target), seconds=0.0,
                log=log.read_text() if log.exists() else "")
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, target, log, tmp, proc, time.perf_counter()))
    failed = []
    for name, target, log, tmp, proc, t0 in jobs:
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{out}")
            continue
        log.write_text(out)
        os.replace(tmp, target)
        BUILD_INFO[name] = dict(path=str(target), seconds=seconds, log=out)
    if failed:
        raise RuntimeError("\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    with _lock:
        if name not in _libs:
            build(name)
            _libs[name] = ctypes.CDLL(BUILD_INFO[name]["path"])
        return _libs[name]
