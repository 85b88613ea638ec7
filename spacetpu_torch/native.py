"""ctypes bindings of the native float64 oracle, `native/nbody_ref.cpp`.

The counterpart of `spacetpu/native.py`, with the same four calls: the
C++ engine with the reference's exact physics (the additive-eps and the
plummer force law, semi-implicit Euler, and the reference's Barnes-Hut
octree), threaded on the host. The tests and `chip_smoke.py` hold the
port's solvers against it at body counts where a Python loop oracle is
unusable.

The library is compiled by ``g++`` (``$CXX``) with the flags of
`native/Makefile` at first use, into ``_build/`` beside this file, keyed
by a hash of the source and the flags. Each build writes a temporary file
and renames it into place, so processes that build at once do not clash.
Nothing is written into ``native/``.

The inputs may be numpy arrays or tensors on any device; every result is
numpy float64, as `spacetpu.native` returns.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np
import torch

_PKG = pathlib.Path(__file__).resolve().parent
SOURCE = _PKG.parent / "native" / "nbody_ref.cpp"
BUILD_DIR = _PKG / "_build"
#: native/Makefile's CXXFLAGS and LDFLAGS
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
            "-Wextra")
LDFLAGS = ("-shared", "-pthread")

SOFTENING = {"ref": 0, "plummer": 1}
ALGORITHM = {"direct": 0, "barnes_hut": 1}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> pathlib.Path:
    """Where the library built from the current source lives."""
    h = hashlib.sha256(" ".join(CXXFLAGS + LDFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"nbody_ref-{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the library unless it is built; returns its path. Raises
    RuntimeError with the compiler's output when the build fails."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, str(SOURCE), "-o",
           str(tmp), *LDFLAGS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE} failed (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target


def lib() -> ctypes.CDLL:
    """The loaded library, built if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib_ = ctypes.CDLL(str(build()))
        dp = ctypes.POINTER(ctypes.c_double)
        i64, f64, i32 = ctypes.c_int64, ctypes.c_double, ctypes.c_int
        lib_.nbody_acc_direct.argtypes = [dp, dp, i64, f64, f64, i32, dp]
        lib_.nbody_acc_barnes_hut.argtypes = [dp, dp, i64, f64, f64, f64, i32,
                                              dp]
        lib_.nbody_rollout.argtypes = [dp, dp, dp, i64, f64, i64, f64, f64,
                                       i32, i32, f64]
        lib_.nbody_total_energy.argtypes = [dp, dp, dp, i64, f64, f64, i32]
        lib_.nbody_total_energy.restype = f64
        _lib = lib_
        return _lib


def _as_c(a, copy: bool = False):
    """A C-contiguous float64 numpy array of `a` and its pointer."""
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float64).numpy()
    a = np.ascontiguousarray(a, np.float64)
    if copy:
        a = a.copy()
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def acc_direct(pos, mass, *, g, eps, softening="ref") -> np.ndarray:
    """All-pairs acceleration (N, 3) of (N, 3) positions and (N,) masses."""
    pos, p = _as_c(pos)
    mass, m = _as_c(mass)
    out, o = _as_c(np.zeros_like(pos))
    lib().nbody_acc_direct(p, m, len(mass), g, eps, SOFTENING[softening], o)
    return out


def acc_barnes_hut(pos, mass, *, theta, g, eps,
                   softening="ref") -> np.ndarray:
    """The reference's octree acceleration (N, 3) at opening angle theta."""
    pos, p = _as_c(pos)
    mass, m = _as_c(mass)
    out, o = _as_c(np.zeros_like(pos))
    lib().nbody_acc_barnes_hut(p, m, len(mass), theta, g, eps,
                               SOFTENING[softening], o)
    return out


def rollout(pos, vel, mass, *, dt, steps, g, eps, softening="ref",
            algorithm="direct", theta=0.5):
    """Semi-implicit Euler rollout; returns (pos, vel) copies."""
    pos, p = _as_c(pos, copy=True)
    vel, v = _as_c(vel, copy=True)
    mass, m = _as_c(mass)
    lib().nbody_rollout(p, v, m, len(mass), dt, steps, g, eps,
                        SOFTENING[softening], ALGORITHM[algorithm], theta)
    return pos, vel


def total_energy(pos, vel, mass, *, g, eps=0.0, softening="plummer") -> float:
    """Kinetic plus pairwise potential energy."""
    pos, p = _as_c(pos)
    vel, v = _as_c(vel)
    mass, m = _as_c(mass)
    return lib().nbody_total_energy(p, v, m, len(mass), g, eps,
                                    SOFTENING[softening])
