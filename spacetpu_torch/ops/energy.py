"""Conservation diagnostics: energy, momentum, angular momentum (PyTorch).

The counterpart of `spacetpu/ops/energy.py`. The potential energy is the
O(N^2) pair sum taken over target chunks, so the working set is
O(chunk * N); for strict checks compute it in float64.
"""

from __future__ import annotations

import torch

from spacetpu_torch import constants
from spacetpu_torch.state import State

#: target chunk of the pair sum: memory is O(chunk * N), never O(N^2).
_PE_CHUNK = 1024


def potential_energy(pos, mass, *, softening: str = "plummer", eps=0.0,
                     g=None):
    """PE = -G * sum_{i<j} m_i m_j / sqrt(r_ij^2 + eps^2) (plummer), or
    with the bare 1/r (softening="ref"). Self pairs are excluded by index,
    since with eps > 0 the softened self term is not zero."""
    if g is None:
        g = constants.G
    eps = float(eps)
    n = pos.shape[0]
    j_idx = torch.arange(n, device=pos.device)
    total = pos.new_zeros(())
    for i0 in range(0, n, _PE_CHUNK):
        pos_i = pos[i0:i0 + _PE_CHUNK]
        rel = pos[None, :, :] - pos_i[:, None, :]  # (C, N, 3)
        r2 = torch.sum(rel * rel, dim=-1)
        d2 = r2 + eps * eps if softening == "plummer" else r2
        inv_r = torch.where(d2 > 0, torch.rsqrt(torch.clamp_min(d2, 1e-38)),
                            0.0)
        self_pair = j_idx[i0:i0 + _PE_CHUNK, None] == j_idx[None, :]
        inv_r = torch.where(self_pair, 0.0, inv_r)
        mm = mass[i0:i0 + _PE_CHUNK, None] * mass[None, :]
        total = total + torch.sum(mm * inv_r)
    # each unordered pair appears twice in the full sum
    return -0.5 * float(g) * total


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
