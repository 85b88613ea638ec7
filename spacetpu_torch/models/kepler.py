"""Keplerian orbital elements -> Cartesian state, with hierarchical
barycenter momentum correction.

Host-side scene setup in f64 numpy (runs once at startup, like the
reference's `convert_params`, `parameters.rs:143-225` of the Rust reference).

The element conversion follows the standard textbook pipeline the reference
implements at `parameters.rs:76-133`: true anomaly -> eccentric anomaly,
radius from a(1 - e cos E), specific angular momentum from mu*a*(1-e^2),
then rotation by longitude-of-ascending-node / argument-of-periapsis /
inclination into the inertial frame.

The hierarchical assembly reproduces the reference's recursive barycenter
momentum fix (`parameters.rs:186-224`): children add momentum to a subsystem,
so each subtree is slowed by children_momentum / subtree_mass to make the
subtree *barycenter* (not its primary) follow the intended orbit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Union

import numpy as np

from spacetpu_torch.constants import AU, G_ABS, M0
from spacetpu_torch.state import Scene


@dataclasses.dataclass
class AbsoluteCoords:
    """Position in meters, velocity in m/s (parameters.rs:40-44)."""

    pos: tuple[float, float, float]
    vel: tuple[float, float, float]


@dataclasses.dataclass
class RelativeCoords:
    """Keplerian elements relative to a named parent (parameters.rs:46-61).
    semi_major_axis in meters; angles in degrees; eccentricity in [0, 1)."""

    parent: str
    semi_major_axis: float
    eccentricity: float
    inclination: float
    arg_periapsis: float
    long_asc_node: float
    true_an: float


@dataclasses.dataclass
class StandardParams:
    """One body of a hierarchical system (parameters.rs:68-74).
    mass in Earth masses, radius in AU, color RGB."""

    name: str
    coordinates: Union[AbsoluteCoords, RelativeCoords]
    mass: float
    radius: float
    color: tuple[float, float, float]


def elements_to_state(
    coords: RelativeCoords,
    parent_pos: np.ndarray,
    parent_vel: np.ndarray,
    parent_mass: float,
    mass: float,
    *,
    reference_quirks: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Convert orbital elements to absolute (pos [m], vel [m/s]).

    Follows the two-body element pipeline of `parameters.rs:76-133` with
    mu = G(M_parent + m). With ``reference_quirks=True`` it reproduces the
    reference's formula *exactly* — including its bug: `parameters.rs:103`
    computes the z position as r*sin(i)*cos(u) where the standard rotation
    gives r*sin(i)*sin(u) (the velocity z term is standard), so the
    reference's inclined orbits violate vis-viva by O(sin^2 i). The default
    is the physically correct conversion."""
    mu = G_ABS * (parent_mass * M0 + mass * M0)
    nu = math.radians(coords.true_an)
    e = coords.eccentricity
    a = coords.semi_major_axis

    ecc_anomaly = math.atan2(math.sqrt(1.0 - e * e) * math.sin(nu), e + math.cos(nu))
    r = a * (1.0 - e * math.cos(ecc_anomaly))
    h = math.sqrt(mu * a * (1.0 - e * e))  # specific angular momentum

    omega = math.radians(coords.long_asc_node)  # longitude of ascending node
    w = math.radians(coords.arg_periapsis)  # argument of periapsis
    inc = math.radians(coords.inclination)

    u = w + nu  # argument of latitude
    cos_o, sin_o = math.cos(omega), math.sin(omega)
    cos_u, sin_u = math.cos(u), math.sin(u)
    cos_i = math.cos(inc)

    sin_i = math.sin(inc)
    z_pos = sin_i * (cos_u if reference_quirks else sin_u)
    p_vec = r * np.array(
        [
            cos_o * cos_u - sin_o * sin_u * cos_i,
            sin_o * cos_u + cos_o * sin_u * cos_i,
            z_pos,
        ]
    )

    p = a * (1.0 - e * e)  # semi-latus rectum
    vel_basis = h * e / (r * p) * math.sin(nu)
    v_vec = p_vec * vel_basis - (h / r) * np.array(
        [
            cos_o * sin_u + sin_o * cos_u * cos_i,
            sin_o * sin_u - cos_o * cos_u * cos_i,
            -sin_i * cos_u,
        ]
    )
    # (parameters.rs:105-117; the z velocity bracket carries the opposite
    # sign of the x/y brackets, hence -sin(i)cos(u) here — this term is the
    # standard one in both modes.)

    return p_vec + parent_pos, v_vec + parent_vel


def convert_params(
    items: Sequence[StandardParams], *, reference_quirks: bool = False
) -> Scene:
    """Assemble a hierarchical system into a Scene (pos AU, vel AU/s).

    Two passes, exactly as the reference (`parameters.rs:143-225`):
    1. forward: resolve each body's absolute pos/vel from its parent's
       (parents must precede children — topological input order);
    2. reverse: for each node, compute the net momentum its children added
       to the subtree and subtract the corresponding velocity from the whole
       subtree, so subtree barycenters follow the intended orbits.
    """
    names: list[str] = []
    by_name: dict[str, int] = {}
    pos = np.zeros((len(items), 3))
    vel = np.zeros((len(items), 3))
    mass = np.zeros(len(items))
    radius = np.zeros(len(items), np.float32)
    color = np.zeros((len(items), 3), np.float32)
    parent = np.full(len(items), -1, np.int64)

    for idx, item in enumerate(items):
        if isinstance(item.coordinates, AbsoluteCoords):
            pos[idx] = item.coordinates.pos
            vel[idx] = item.coordinates.vel
        else:
            p_idx = by_name[item.coordinates.parent]
            parent[idx] = p_idx
            pos[idx], vel[idx] = elements_to_state(
                item.coordinates, pos[p_idx], vel[p_idx], mass[p_idx], item.mass,
                reference_quirks=reference_quirks,
            )
        mass[idx] = item.mass
        radius[idx] = item.radius
        color[idx] = item.color
        names.append(item.name)
        by_name[item.name] = idx

    # Reverse barycenter-momentum pass (parameters.rs:200-222).
    n = len(items)
    children: list[list[int]] = [[] for _ in range(n)]
    children_mass = np.zeros(n)
    children_momentum = np.zeros((n, 3))

    def apply_vdiff(idx: int, v_diff: np.ndarray):
        vel[idx] -= v_diff
        for c in children[idx]:
            apply_vdiff(c, v_diff)

    for i in reversed(range(n)):
        v_diff = children_momentum[i] / (mass[i] + children_mass[i])
        apply_vdiff(i, v_diff)
        p = parent[i]
        if p >= 0:
            own_momentum = (vel[i] - vel[p]) * (mass[i] + children_mass[i]) + (
                children_momentum[i]
            )
            children_mass[p] += mass[i] + children_mass[i]
            children_momentum[p] += own_momentum
            children[p].append(i)

    # Meters -> AU (and m/s -> AU/s), as in the reference's Object conversion
    # (parameters.rs:25-38).
    return Scene(
        names=names,
        colors=color,
        radii=radius,
        pos=pos / AU,
        vel=vel / AU,
        mass=mass,
    )
