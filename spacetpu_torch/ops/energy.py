"""Conservation diagnostics: energy, momentum, angular momentum (PyTorch).

The counterpart of `spacetpu/ops/energy.py`. The potential energy is the
O(N^2) pair sum. On the card it is one launch of the CUDA kernel
``pair_potential`` (``csrc/direct.cu``), which sums each body's terms in
registers and writes one partial a body; on the CPU it is the plain
version, taken over target chunks so the working set is O(chunk * N). For
strict checks compute it in float64.
"""

from __future__ import annotations

import ctypes

import torch

from spacetpu_torch import _build, constants
from spacetpu_torch.state import State

#: target chunk of the plain pair sum: memory is O(chunk * N), never O(N^2).
_PE_CHUNK = 1024

#: Kernel launches since the last reset, by kernel name. The wrapper adds
#: one where it launches its kernel, and nowhere else.
LAUNCHES = {"pair_potential": 0}

_DTYPES = {torch.float32: 0, torch.float64: 1}
_LAWS = {"plummer": 0, "ref": 1}


def _lib() -> ctypes.CDLL:
    lib = _build.library("direct")
    if lib.spacetpu_pair_potential.argtypes is None:
        lib.spacetpu_pair_potential.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_double, ctypes.c_void_p]
        lib.spacetpu_pair_potential.restype = ctypes.c_int
    return lib


def pair_potential_plain(pos, mass, *, softening: str = "plummer",
                         eps=0.0):
    """The plain version of ``pair_potential``: (N,) per-body sums
    sum_{j != i} m_j / sqrt(r_ij^2 + eps^2) (plummer) or m_j / r_ij
    (softening="ref"), 0 where the softened distance is 0. Self pairs are
    excluded by index, since with eps > 0 the softened self term is not
    zero."""
    eps = float(eps)
    n = pos.shape[0]
    j_idx = torch.arange(n, device=pos.device)
    out = []
    for i0 in range(0, n, _PE_CHUNK):
        pos_i = pos[i0:i0 + _PE_CHUNK]
        rel = pos[None, :, :] - pos_i[:, None, :]  # (C, N, 3)
        r2 = torch.sum(rel * rel, dim=-1)
        d2 = r2 + eps * eps if softening == "plummer" else r2
        inv_r = torch.where(d2 > 0, torch.rsqrt(torch.clamp_min(d2, 1e-38)),
                            0.0)
        self_pair = j_idx[i0:i0 + _PE_CHUNK, None] == j_idx[None, :]
        inv_r = torch.where(self_pair, 0.0, inv_r)
        out.append(torch.sum(inv_r * mass[None, :], dim=1))
    return torch.cat(out) if out else pos.new_zeros((0,))


def pair_potential(pos, mass, *, softening: str = "plummer", eps=0.0):
    """(N, 3), (N,) -> (N,) per-body sums of ``pair_potential_plain``. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if softening not in _LAWS:
        raise ValueError(f"unknown softening {softening!r}")
    n = pos.shape[0]
    if pos.shape != (n, 3) or mass.shape != (n,):
        raise ValueError(f"bad shapes pos={tuple(pos.shape)} "
                         f"mass={tuple(mass.shape)}")
    if pos.dtype not in _DTYPES or mass.dtype != pos.dtype:
        raise TypeError(f"pos and mass must share one dtype of float32 or "
                        f"float64, got {pos.dtype} and {mass.dtype}")
    if mass.device != pos.device:
        raise ValueError("pos and mass must be on one device")
    if pos.device.type == "cpu":
        return pair_potential_plain(pos, mass, softening=softening, eps=eps)
    if pos.device.type != "cuda":
        raise ValueError(f"no pair_potential kernel for device {pos.device}")
    out = pos.new_empty((n,))
    if n == 0:
        return out
    body = torch.cat([pos, mass[:, None]], dim=1).contiguous()
    with torch.cuda.device(pos.device):
        rc = _lib().spacetpu_pair_potential(
            _DTYPES[pos.dtype], _LAWS[softening], body.data_ptr(),
            out.data_ptr(), n, float(eps),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pair_potential launch failed: CUDA error {rc}")
    LAUNCHES["pair_potential"] += 1
    return out


def potential_energy(pos, mass, *, softening: str = "plummer", eps=0.0,
                     g=None):
    """PE = -G * sum_{i<j} m_i m_j / sqrt(r_ij^2 + eps^2) (plummer), or
    with the bare 1/r (softening="ref"): -G/2 sum_i m_i (sum_{j != i}
    m_j / d_ij), each unordered pair appearing twice in the full sum."""
    if g is None:
        g = constants.G
    per_body = pair_potential(pos, mass, softening=softening, eps=eps)
    return -0.5 * float(g) * torch.sum(mass * per_body)


def kinetic_energy(vel, mass):
    return 0.5 * torch.sum(mass * torch.sum(vel * vel, dim=-1))


def total_energy(pos, vel, mass, *, softening: str = "plummer", eps=0.0,
                 g=None):
    return kinetic_energy(vel, mass) + potential_energy(
        pos, mass, softening=softening, eps=eps, g=g)


def momentum(vel, mass):
    return torch.sum(mass[:, None] * vel, dim=0)


def angular_momentum(pos, vel, mass):
    return torch.sum(mass[:, None] * torch.linalg.cross(pos, vel), dim=0)


def diagnostics(state: State, *, softening: str = "plummer", eps=0.0,
                g=None) -> dict:
    """Return a dict of conserved quantities for the given state."""
    ke = kinetic_energy(state.vel, state.mass)
    pe = potential_energy(state.pos, state.mass, softening=softening,
                          eps=eps, g=g)
    return {
        "kinetic": ke,
        "potential": pe,
        "energy": ke + pe,
        "momentum": momentum(state.vel, state.mass),
        "angular_momentum": angular_momentum(state.pos, state.vel,
                                             state.mass),
    }
