"""Scene presets: initial body distributions.

Port of the Rust reference's `presets.rs` — same
distributions and unit system, built vectorized in numpy f64 on the host
(scene setup runs once; the arrays then move to device as one transfer).
Adds `random_cluster` and `plummer_sphere` (natural-unit benchmark scenes
used for the north-star throughput/energy-drift configs, which the
reference does not need because it never benchmarks at scale).
"""

from __future__ import annotations

import math

import numpy as np

from spacetpu_torch.constants import AU, G, M0
from spacetpu_torch.models.kepler import (
    AbsoluteCoords,
    RelativeCoords,
    StandardParams,
    convert_params,
)
from spacetpu_torch.state import Body, Scene


def earth_sun_basic() -> Scene:
    """Two-body Earth-Sun with hand-set circular-ish velocities
    (presets.rs:11-34)."""
    return Scene.from_bodies(
        [
            Body(
                name="sun",
                pos=(0.0, 0.0, 0.0),
                vel=(0.0, 1e3 / AU, 0.0),
                mass=333000.0,
                color=(1.0, 1.0, 0.0),
                radius=696340e3 / AU,
            ),
            Body(
                name="earth",
                pos=(1.0, 0.0, 0.0),
                vel=(0.0, (29.8e3 + 1e3) / AU, 0.0),
                mass=1.0,
                color=(0.0, 0.0, 1.0),
                radius=6371e3 / AU,
            ),
        ]
    )


def earth_sun_mars_params() -> list[StandardParams]:
    """Sun/Earth/Moon/Mars with JPL-style elements (presets.rs:36-98)."""
    return [
        StandardParams(
            name="sun",
            coordinates=AbsoluteCoords(pos=(0.0, 0.0, 0.0), vel=(0.0, 0.0, 0.0)),
            mass=333000.0,
            radius=696340e3 / AU,
            color=(1.0, 1.0, 0.0),
        ),
        StandardParams(
            name="earth",
            coordinates=RelativeCoords(
                parent="sun",
                semi_major_axis=1.495365477412831e08 * 1e3,
                eccentricity=1.639588231990315e-02,
                inclination=3.670030330713475e-03,
                arg_periapsis=2.557573855355361e02,
                long_asc_node=2.087400227953831e02,
                true_an=3.450278328909303e02,
            ),
            mass=1.0,
            radius=6371e3 / AU,
            color=(0.0, 0.0, 1.0),
        ),
        StandardParams(
            name="moon",
            coordinates=RelativeCoords(
                parent="earth",
                semi_major_axis=3.815880763110870e05 * 1e3,
                eccentricity=3.179523012872624e-02,
                inclination=5.064604179512905e00,
                arg_periapsis=3.012277898101174e02,
                long_asc_node=2.229402837659016e01,
                true_an=6.454243862420770e01,
            ),
            mass=7.349e22 / M0,
            radius=1737e3 / AU,
            color=(1.0, 1.0, 1.0),
        ),
        StandardParams(
            name="mars",
            coordinates=RelativeCoords(
                parent="sun",
                semi_major_axis=227956e6,
                eccentricity=0.0935,
                inclination=1.848,
                arg_periapsis=286.5,
                long_asc_node=49.578,
                true_an=0.0,
            ),
            mass=0.107,
            radius=3396.2e3 / AU,
            color=(1.0, 0.0, 0.0),
        ),
    ]


def earth_sun_mars() -> Scene:
    return convert_params(earth_sun_mars_params())


def big_boy_on_collision_course() -> Body:
    """A massive intruder aimed at the inner system (presets.rs:108-119)."""
    return Body(
        name="big_boy",
        pos=(3.0, 0.0, 0.0),
        vel=(-0.5e5 / AU, -0.2e5 / AU, 0.0),
        mass=100000.0,
        color=(0.0, 1.0, 0.0),
        radius=1e6 / AU,
    )


def asteroid_belt(n_asteroids: int, *, seed: int = 0) -> list[StandardParams]:
    """Randomized belt elements around the sun (presets.rs:121-148).
    Seeded (the reference uses thread_rng; we take an explicit seed for
    reproducible tests/benches)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_asteroids):
        col = 0.5 + rng.uniform(-0.2, 0.2)
        out.append(
            StandardParams(
                name=f"asteroid_{i}",
                coordinates=RelativeCoords(
                    parent="sun",
                    semi_major_axis=300000e6 + rng.uniform(-1.0, 1.0) * 25_000e6,
                    eccentricity=rng.uniform(0.0, 0.15),
                    inclination=rng.uniform(0.0, 10.0),
                    arg_periapsis=rng.uniform(0.0, 360.0),
                    long_asc_node=rng.uniform(0.0, 360.0),
                    true_an=rng.uniform(0.0, 360.0),
                ),
                mass=float(rng.uniform(1e-10, 1e-6)),
                radius=float(rng.uniform(1e3 / AU, 1e6 / AU)),
                color=(col, col, col),
            )
        )
    return out


def earth_sun_mars_ast(n_asteroids: int = 10000, *, seed: int = 0) -> Scene:
    """Inner system plus an asteroid belt (presets.rs:126-130)."""
    return convert_params(earth_sun_mars_params() + asteroid_belt(n_asteroids, seed=seed))


_CLOUD_CENTER = np.array([-15.0, 0.0, 0.0])
_ROT_AXIS = np.array([0.0, 1.0, 1.0]) / math.sqrt(2.0)


def fixed_cloud(n_objects: int) -> Scene:
    """Cubic grid of 1e4-mass bodies orbiting a 1e7-mass center at
    (-15, 0, 0) (presets.rs:150-198). Deterministic — the default
    interactive workload of the reference (main.rs:61 uses n=10000).

    Each grid body gets velocity axis x r_hat * sqrt(G*M/r): circular-orbit
    speed about the (0,1,1) axis through the center (not normalized after the
    cross product, matching the reference)."""
    lo, hi = -10.0, 10.0
    idx_step = int(math.ceil(n_objects ** (1.0 / 3.0)))
    step = (hi - lo) / idx_step

    i = np.arange(n_objects)
    pos = np.stack(
        [
            lo + (i % idx_step) * step,
            lo + ((i // idx_step) % idx_step) * step,
            lo + ((i // (idx_step * idx_step)) % idx_step) * step,
        ],
        axis=-1,
    ).astype(np.float64)

    rel = pos - _CLOUD_CENTER
    radius = np.linalg.norm(rel, axis=-1, keepdims=True)
    norm_pos = rel / radius
    vel_basis = np.sqrt(G * 1e7 / radius)
    vel = np.cross(np.broadcast_to(_ROT_AXIS, norm_pos.shape), norm_pos) * vel_basis

    col_rel = pos - np.array([lo, lo, lo])
    col_norm = np.linalg.norm(col_rel, axis=-1, keepdims=True)
    colors = np.where(col_norm > 0, col_rel / np.maximum(col_norm, 1e-30), 0.0)

    names = ["Center"] + [f"particle_{k}" for k in range(n_objects)]
    return Scene(
        names=names,
        colors=np.concatenate(
            [np.ones((1, 3), np.float32), colors.astype(np.float32)], axis=0
        ),
        radii=np.concatenate(
            [[1e5 / AU], np.full(n_objects, 1e4 / AU)]
        ).astype(np.float32),
        pos=np.concatenate([_CLOUD_CENTER[None, :], pos], axis=0),
        vel=np.concatenate([np.zeros((1, 3)), vel], axis=0),
        mass=np.concatenate([[1e7], np.full(n_objects, 1e4)]),
    )


def fixed_shell(n_objects: int) -> Scene:
    """Massless spherical shell around a 1e7-mass center
    (presets.rs:200-251). Shell bodies have zero mass: they feel gravity but
    exert none (the edge case the reference's tree handles by excluding
    massless bodies, tree.rs:124-131)."""
    idx_step = int(math.ceil(math.sqrt(n_objects)))
    pi_step = math.pi / idx_step

    i = np.arange(n_objects)
    theta = pi_step * ((i // idx_step) % idx_step)
    phi = 2.0 * pi_step * (i % idx_step)
    shell_r = 10.0
    pos = np.stack(
        [
            shell_r * np.sin(theta) * np.cos(phi),
            shell_r * np.sin(theta) * np.sin(phi),
            shell_r * np.cos(theta),
        ],
        axis=-1,
    )
    radius = np.linalg.norm(pos, axis=-1, keepdims=True)
    radius = np.maximum(radius, 1e-30)
    norm_pos = pos / radius
    vel_basis = np.sqrt(G * 1e7 / radius)
    cross = np.cross(np.broadcast_to(_ROT_AXIS, norm_pos.shape), norm_pos)
    cross_n = np.linalg.norm(cross, axis=-1, keepdims=True)
    # Here the reference *does* normalize the tangent (presets.rs:237).
    vel = cross / np.maximum(cross_n, 1e-30) * vel_basis

    col_rel = pos + radius
    col_norm = np.linalg.norm(col_rel, axis=-1, keepdims=True)
    colors = col_rel / np.maximum(col_norm, 1e-30)

    names = ["Center"] + [f"particle_{k}" for k in range(n_objects)]
    return Scene(
        names=names,
        colors=np.concatenate(
            [np.ones((1, 3), np.float32), colors.astype(np.float32)], axis=0
        ),
        radii=np.concatenate(
            [[1e5 / AU], np.full(n_objects, 1e4 / AU)]
        ).astype(np.float32),
        pos=np.concatenate([np.zeros((1, 3)), pos], axis=0),
        vel=np.concatenate([np.zeros((1, 3)), vel], axis=0),
        mass=np.concatenate([[1e7], np.zeros(n_objects)]),
    )


def random_cluster(n: int, *, seed: int = 0, g: float = 1.0) -> Scene:
    """Natural-unit (G=1) random cluster for benchmarks: uniform ball of
    radius 1, virial-ish velocities, equal masses summing to 1. New in this
    project (matches the workload of the reference's criterion bench,
    `benches/barnes_hut.rs:17-28`, which draws uniform random bodies)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    r = rng.uniform(0, 1, size=(n, 1)) ** (1.0 / 3.0)
    pos = u * r
    v_scale = math.sqrt(0.5 * g)  # ~virial for a uniform unit ball of unit mass
    vel = rng.normal(size=(n, 3)) * v_scale * 0.3
    mass = np.full(n, 1.0 / n)
    return Scene(
        names=[f"p{k}" for k in range(n)],
        colors=rng.uniform(0.3, 1.0, size=(n, 3)).astype(np.float32),
        radii=np.full(n, 1e-3, np.float32),
        pos=pos,
        vel=vel,
        mass=mass,
        g=g,
    )


def plummer_sphere(n: int, *, seed: int = 0, a: float = 1.0) -> Scene:
    """Plummer-model cluster in natural units (G=1, M=1): the standard
    equilibrium initial condition for energy-drift validation. New in this
    project."""
    rng = np.random.default_rng(seed)
    # radius via inverse transform of the Plummer cumulative mass profile
    m = rng.uniform(0, 1, size=n)
    r = a / np.sqrt(m ** (-2.0 / 3.0) - 1.0)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    pos = u * r[:, None]
    # velocities from the isotropic distribution via von Neumann rejection
    x = np.zeros(n)
    todo = np.ones(n, bool)
    while todo.any():
        k = int(todo.sum())
        x1 = rng.uniform(0, 1, size=k)
        x2 = rng.uniform(0, 0.1, size=k)
        ok = x2 < x1 * x1 * (1.0 - x1 * x1) ** 3.5
        idx = np.nonzero(todo)[0][ok]
        x[idx] = x1[ok]
        todo[idx] = False
    v_esc = np.sqrt(2.0) * (1.0 + r * r / (a * a)) ** (-0.25)
    speed = x * v_esc
    uv = rng.normal(size=(n, 3))
    uv /= np.linalg.norm(uv, axis=-1, keepdims=True)
    vel = uv * speed[:, None]
    mass = np.full(n, 1.0 / n)
    return Scene(
        names=[f"p{k}" for k in range(n)],
        colors=rng.uniform(0.3, 1.0, size=(n, 3)).astype(np.float32),
        radii=np.full(n, 1e-3, np.float32),
        pos=pos - pos.mean(0),
        vel=vel - vel.mean(0),
        mass=mass,
        g=1.0,  # natural units
    )


def earth_sun_mars_big_boy() -> Scene:
    """Inner system plus the massive intruder — the commented-out scenario
    of main.rs:63-64 promoted to a first-class preset."""
    base = earth_sun_mars()
    bb = big_boy_on_collision_course()
    return Scene(
        names=base.names + [bb.name],
        colors=np.concatenate(
            [base.colors, np.asarray([bb.color], np.float32)]
        ),
        radii=np.concatenate([base.radii, [bb.radius]]).astype(np.float32),
        pos=np.concatenate([base.pos, [list(bb.pos)]]),
        vel=np.concatenate([base.vel, [list(bb.vel)]]),
        mass=np.concatenate([base.mass, [bb.mass]]),
        g=base.g,
    )


def colliding_plummers(n: int, *, seed: int = 0, a: float = 1.0,
                       separation: float = 6.0, v_rel: float = 0.5) -> Scene:
    """Two Plummer spheres (each M=1/2, scale a) on a head-on approach —
    a merger scene whose density structure changes qualitatively over the
    rollout, the workload auto-recalibration exists for
    (`spacetpu`'s Simulation.maybe_recalibrate). New in this
    project; natural units (G=1)."""
    n1 = n // 2
    s1 = plummer_sphere(n1, seed=seed, a=a)
    s2 = plummer_sphere(n - n1, seed=seed + 1, a=a)
    # each sphere's mass is halved below (total M=1), so its internal
    # velocities must scale by sqrt(1/2) (v ~ sqrt(G*M)) to stay a bound
    # virial equilibrium — at M=1 speeds each sphere would sit at
    # 2T/|W| = 2 and evaporate during the approach
    vscale = math.sqrt(0.5)

    def _truncate(pos, r_max=8.0 * a):
        # truncate each halo (the Plummer tail is unbounded; standard
        # practice for merger ICs, and it keeps the pair visually and
        # dynamically distinct at the chosen separation)
        r = np.linalg.norm(pos, axis=-1, keepdims=True)
        return pos * np.minimum(1.0, r_max / np.maximum(r, 1e-12))

    dx = np.array([separation / 2, 0.0, 0.0])
    dv = np.array([v_rel / 2, 0.0, 0.0])
    return Scene(
        names=[f"a{k}" for k in range(n1)] + [f"b{k}" for k in range(n - n1)],
        colors=np.concatenate([s1.colors, s2.colors]),
        radii=np.concatenate([s1.radii, s2.radii]),
        pos=np.concatenate([_truncate(s1.pos) - dx, _truncate(s2.pos) + dx]),
        vel=np.concatenate([s1.vel * vscale + dv, s2.vel * vscale - dv]),
        mass=np.concatenate([s1.mass, s2.mass]) * 0.5,
        g=1.0,
    )


PRESETS = {
    "earth_sun_basic": earth_sun_basic,
    "earth_sun_mars": earth_sun_mars,
    "earth_sun_mars_ast": earth_sun_mars_ast,
    "earth_sun_mars_big_boy": earth_sun_mars_big_boy,
    "fixed_cloud": fixed_cloud,
    "fixed_shell": fixed_shell,
    "random_cluster": random_cluster,
    "plummer_sphere": plummer_sphere,
    "colliding_plummers": colliding_plummers,
}
