"""Conservation diagnostics: energy, momentum, angular momentum (PyTorch).

The counterpart of `spacetpu/ops/energy.py`. The potential energy is the
O(N^2) pair sum. On the card it is the CUDA kernels of ``pair_potential``
(``csrc/direct.cu``), which evaluate each unordered pair once: the bodies
fall into blocks of rows, each block sweeps the tile pairs of its band of
the half ring (``potential_bands``) with its rows' sums in registers, and
every partial is joined in a fixed order, so two calls give the same bits.
On the CPU it is the plain version, taken over target chunks so the
working set is O(chunk * N). For strict checks compute it in float64.
"""

from __future__ import annotations

import ctypes

import torch

from spacetpu_torch import _build, constants
from spacetpu_torch.state import State

#: target chunk of the plain pair sum: memory is O(chunk * N), never O(N^2).
_PE_CHUNK = 1024

#: Offsets of the half ring a band launch takes: the scratch of the column
#: partials is POTENTIAL_SLOTS * N values (64 MB at 1M float32 bodies).
POTENTIAL_SLOTS = 16

#: Calls since the last reset, by name. The wrapper adds one where it
#: launches its kernels, and nowhere else: a call of ``pair_potential`` on
#: the card counts one, though it launches the diagonal kernel, a kernel a
#: band of ``potential_bands`` and the join (``KERNEL_LAUNCHES``).
LAUNCHES = {"pair_potential": 0}

#: Kernels launched since the last reset: the wrapper adds, where it
#: launches them, the count that the C entry reports it launched.
KERNEL_LAUNCHES = {"pair_potential_kernels": 0}

_DTYPES = {torch.float32: 0, torch.float64: 1}
_LAWS = {"plummer": 0, "ref": 1}
_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = _build.library("direct")
    if lib.spacetpu_pair_potential.argtypes is None:
        lib.spacetpu_pair_potential.argtypes = [
            ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_longlong,
            ctypes.c_double, _P, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), _P]
        lib.spacetpu_pair_potential.restype = ctypes.c_int
        lib.spacetpu_pair_potential_rows.argtypes = [ctypes.c_int]
        lib.spacetpu_pair_potential_rows.restype = ctypes.c_int
    return lib


def potential_bands(n: int, rows: int, slots: int) -> list[tuple[int, int]]:
    """The band launches of ``pair_potential``'s half ring, (d_lo, d_hi)
    each: N bodies fall into B = ceil(N / rows) blocks, block I takes the
    tile pairs (I, (I + d) mod B) for d = 1 .. B // 2 (for an even B, d = B
    / 2 only for I < B / 2), and a band holds at most `slots` consecutive
    offsets, each with its own slot of column partials."""
    half = -(-n // rows) // 2
    return [(lo, min(lo + slots - 1, half))
            for lo in range(1, half + 1, slots)]


def potential_rows(dtype) -> int:
    """The rows a block of the kernels takes in `dtype` (the built
    library's constant)."""
    return int(_lib().spacetpu_pair_potential_rows(_DTYPES[dtype]))


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
    tensor takes the plain version; a CUDA tensor launches the kernels
    (the diagonal tiles, the bands of ``potential_bands``, the join) or
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
    rows = potential_rows(pos.dtype)
    bands = potential_bands(n, rows, POTENTIAL_SLOTS)
    slots = max((hi - lo + 1 for lo, hi in bands), default=0)
    work = pos.new_empty((slots, n))
    flat = (ctypes.c_longlong * (2 * len(bands)))(
        *(d for band in bands for d in band))
    launched = ctypes.c_int(0)
    with torch.cuda.device(pos.device):
        rc = _lib().spacetpu_pair_potential(
            _DTYPES[pos.dtype], _LAWS[softening], body.data_ptr(),
            out.data_ptr(), n, float(eps), work.data_ptr(), slots, flat,
            len(bands), ctypes.byref(launched),
            torch.cuda.current_stream().cuda_stream)
    KERNEL_LAUNCHES["pair_potential_kernels"] += launched.value
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
