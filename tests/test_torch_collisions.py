"""The port's collision merging (`spacetpu_torch/ops/collisions.py`), the
engine's `merge_every` and the headless `--merge-collisions` against
`spacetpu` on the CPU, float64 from the same numpy inputs: every output of
a merge (state, radii, merged, the pair, the energy lost) to 1e-12, the
merge loop's count, a dead tracer that must not shadow another encounter,
a rollout that merges, and the printed lines of both packages. The merge
loop keeps its nearest-neighbour table across merges: after every merge
it is held bit for bit against a loop of the port's `merge_closest` (a full
search a merge) and to 1e-12 against the JAX package's loop, on a chain of
merges, a host that collects dead tracers, a merged body that becomes the
nearest of many rows, the rows all left to search again, and max_merges
reached; one full search serves eight merges."""

import re
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spacetpu
import spacetpu_torch
from spacetpu.ops import collisions as jcol
from spacetpu_torch.engine import Exchange, SimEngine, run_sim_loop
from spacetpu_torch.ops import collisions, encounters
from spacetpu_torch.state import make_state
from tests.nearest_sym import merge_loop_full
from tests.parity import one_torch_thread  # noqa: F401


def _both(pos, vel, mass):
    """The same state in both packages, its acc cache set to ones (to see
    the merged rows' zeroed)."""
    args = [np.asarray(x, float) for x in (pos, vel, mass)]
    ts = make_state(*args, dtype=torch.float64, device="cpu")
    js = spacetpu.make_state(*args, dtype=jnp.float64)
    return (ts._replace(acc=torch.ones_like(ts.pos)),
            js._replace(acc=jnp.ones_like(js.pos)))


def _assert_state(ts, js):
    for f in ("pos", "vel", "mass", "acc"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-12,
                                   atol=1e-14, err_msg=f)


#: (positions, velocities, masses, radii) of the merge cases
MERGES = {
    "overlap": ([[0.0, 0, 0], [0.05, 0, 0], [10, 0, 0]],
                [[1.0, 0, 0], [-1, 0, 0], [0, 1, 0]], [2.0, 1.0, 5.0],
                [0.04, 0.04, 0.01]),
    "apart": ([[0.0, 0, 0], [1.0, 0, 0]], [[0.0, 0, 0], [0, 0, 0]],
              [1.0, 1.0], [0.1, 0.1]),
    "massless": ([[0.0, 0, 0], [0.01, 0, 0], [5.0, 0, 0]],
                 [[0.0, 1, 0], [0, 0, 0], [0, 0, 0]], [0.0, 0.0, 1.0],
                 [0.1, 0.1, 0.1]),
    "dead_tracer": ([[0.0, 0, 0], [0.0, 0, 0], [0.03, 0, 0]],
                    [[0.0, 0, 0], [0, 0, 1], [1, 0, 0]], [1.0, 0.0, 3.0],
                    [0.1, 0.0, 0.02]),
}


@pytest.mark.parametrize("name", list(MERGES))
def test_merge_closest_matches_jax(name):
    """Every output of one merge: the pair, `merged`, the momentum-
    conserving barycentre, the volume-additive radius, zeroed acc rows and
    the relative-motion energy lost; no merge where the bodies are apart or
    both massless; a dead tracer (radius 0) is no partner."""
    pos, vel, mass, radii = MERGES[name]
    ts, js = _both(pos, vel, mass)
    r = collisions.merge_closest(ts, torch.as_tensor(radii, dtype=torch.float64))
    jr = jcol.merge_closest(js, jnp.asarray(radii, jnp.float64))
    assert bool(r.merged) == bool(jr.merged)
    assert (int(r.i), int(r.j)) == (int(jr.i), int(jr.j))
    _assert_state(r.state, jr.state)
    np.testing.assert_allclose(r.radii.numpy(), np.asarray(jr.radii),
                               rtol=1e-12)
    assert float(r.energy_lost) == pytest.approx(float(jr.energy_lost),
                                                 rel=1e-12, abs=0)
    if name == "overlap":
        assert bool(r.merged) and float(r.energy_lost) == pytest.approx(
            4.0 / 3.0, rel=1e-12)
    if name in ("apart", "massless"):
        assert not bool(r.merged)


def test_dead_tracer_does_not_shadow_other_encounters():
    """Two independent overlapping pairs: after the first merge its tracer
    sits on its host at d = 0 with radius 0, and the second pair still
    merges; then nothing overlaps."""
    ts, js = _both([[0.0, 0, 0], [0.05, 0, 0], [10.0, 0, 0], [10.06, 0, 0]],
                   [[0.0, 0, 0]] * 4, [1.0, 1.0, 1.0, 1.0])
    radii = [0.04] * 4
    st, r, n, de = collisions.merge_all_overlapping(
        ts, torch.as_tensor(radii, dtype=torch.float64))
    jst, jr, jn, jde = jcol.merge_all_overlapping(
        js, jnp.asarray(radii, jnp.float64))
    assert n == jn == 2 and de == pytest.approx(jde, rel=1e-12, abs=1e-300)
    assert sorted(st.mass.tolist()) == [0.0, 0.0, 2.0, 2.0]
    _assert_state(st, jst)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-12)
    assert not bool(collisions.merge_closest(st, r).merged)


def test_collision_course_rollout_matches_jax():
    """Two bodies launched at each other: both packages merge at the same
    step, then integrate on with the same state (1e-10)."""
    pos = [[-1.0, 0, 0], [1.0, 0, 0]]
    vel = [[0.5, 0, 0], [-0.5, 0, 0]]
    kw = dict(algorithm="direct", softening="plummer", eps=1e-3, g=1.0)
    ts, js = _both(pos, vel, [1.0, 1.0])
    sim = spacetpu_torch.make_simulation(2, device="cpu", **kw)
    jsim = spacetpu.make_simulation(2, backend="xla", **kw)
    ts, js = sim.prime(ts), jsim.prime(js)
    radii = torch.as_tensor([0.05, 0.05], dtype=torch.float64)
    jradii = jnp.asarray([0.05, 0.05], jnp.float64)
    merged_at = []
    for step in range(200):
        ts, js = sim.step(ts, 2e-2), jsim.step(js, 2e-2)
        r = collisions.merge_closest(ts, radii)
        jr = jcol.merge_closest(js, jradii)
        assert bool(r.merged) == bool(jr.merged)
        ts, radii, js, jradii = r.state, r.radii, jr.state, jr.radii
        if bool(r.merged):
            merged_at.append(step)
            ts, js = sim.prime(ts), jsim.prime(js)
            break
    assert merged_at
    ts, js = sim.run(ts, 2e-2, 10), jsim.run(js, 2e-2, 10)
    assert sorted(ts.mass.tolist()) == [0.0, 2.0]
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos),
                               rtol=1e-10, atol=1e-12)


def _pair_sim():
    st = make_state(np.array([[-0.5, 0, 0], [0.5, 0, 0]]),
                    np.array([[0.25, 0, 0], [-0.25, 0, 0]]),
                    np.array([1.0, 1.0]), dtype=torch.float64, device="cpu")
    sim = spacetpu_torch.make_simulation(2, algorithm="direct",
                                         softening="plummer", eps=1e-3,
                                         g=1.0, device="cpu")
    return sim, st


def test_engine_merges_and_publishes_radii():
    """SimEngine(merge_every=2): the sim thread merges at batch cadence and
    publishes the radii (volume-additive, the tracer's 0), as the JAX
    package's engine does on the same scene."""
    from spacetpu.engine import SimEngine as JEngine

    sim, st = _pair_sim()
    radii = np.array([0.05, 0.05])
    want = (2 * 0.05 ** 3) ** (1 / 3)
    results = []
    for make in (lambda: SimEngine(sim, st, delta=2e-2, merge_every=2,
                                   radii=radii),
                 lambda: JEngine(spacetpu.make_simulation(
                     2, algorithm="direct", backend="xla",
                     softening="plummer", eps=1e-3, g=1.0),
                     spacetpu.make_state(st.pos.numpy(), st.vel.numpy(),
                                         st.mass.numpy(), dtype=jnp.float64),
                     delta=2e-2, merge_every=2, radii=radii)):
        eng = make()
        np.testing.assert_array_equal(eng.radii_snapshot,
                                      np.float32([0.05, 0.05]))
        with eng:
            deadline = time.time() + 60
            while time.time() < deadline:
                eng.check_health()
                if float(eng.radii_snapshot.max()) > 0.055:
                    break
                time.sleep(0.02)
        assert eng.final_state is not None
        results.append((sorted(np.asarray(eng.final_state.mass).tolist()),
                        sorted(eng.radii_snapshot.tolist())))
    for masses, r in results:
        assert masses == [0.0, 2.0]
        assert r[0] == 0.0 and r[1] == pytest.approx(want, rel=1e-5)
    assert results[0][1] == results[1][1]


def test_sim_loop_merges_at_its_cadence():
    """run_sim_loop with merge_every=3 and check_interval=1: the first
    check at tick 3; on_merge gets float32 radii once the pair merged, and
    the loop's final state is primed (finite acc, summed mass)."""
    sim, st = _pair_sim()
    got = []
    stop = threading.Event()
    ex = Exchange(2, delta=2e-2)

    def on_merge(r):
        got.append(r)
        stop.set()

    out = run_sim_loop(sim, st, ex, stop, merge_every=3,
                       radii=np.array([0.05, 0.05]), on_merge=on_merge)
    assert got and got[0].dtype == np.float32 and sorted(got[0])[0] == 0.0
    assert ex.current_ticks() % 3 == 0
    assert sorted(out.mass.tolist()) == [0.0, 2.0]
    assert bool(torch.isfinite(out.acc).all())


def _merge_lines(out):
    return [m.group(0) for m in re.finditer(
        r"(  \.\.\. step \d+: merged .*|collisions: .*|"
        r"min separation \(\w+\): .*)", out)]


def test_cli_merge_collisions_matches_jax(capsys, tmp_path):
    """`--merge-collisions 2` on a restored random cluster whose radii
    (0.03) overlap: the same merge lines, the same closing `collisions:`
    line and the same separations in both packages."""
    from spacetpu.main import main as jmain
    from spacetpu_torch.io import checkpoint
    from spacetpu_torch.main import main
    from spacetpu_torch.models import presets

    scene = presets.random_cluster(200, seed=1)
    scene.radii = np.full(200, 0.03, np.float32)
    path = str(tmp_path / "overlaps.npz")
    checkpoint.save(path, scene.state(dtype=torch.float64, device="cpu"),
                    scene=scene)
    argv = ["--platform", "cpu", "--restore", path, "--algorithm", "direct",
            "--frontend", "none", "--steps", "4", "--dt", "1e-3",
            "--dtype", "float64", "--merge-collisions", "2",
            "--report-encounters"]
    main(argv)
    mine = _merge_lines(capsys.readouterr().out)
    jmain(argv)
    theirs = _merge_lines(capsys.readouterr().out)
    assert any(line.startswith("collisions: ") for line in mine)
    assert len(mine) >= 4 and mine == theirs


# --- the incremental merge loop ---------------------------------------------


def _icosahedron(centre, radius):
    """The 12 vertices of an icosahedron of circumradius `radius` (edge
    1.05 radius) about `centre`."""
    g = (1 + 5 ** 0.5) / 2
    v = np.array([[0, s1, s2 * g] for s1 in (-1, 1) for s2 in (-1, 1)]
                 + [[s1, s2 * g, 0] for s1 in (-1, 1) for s2 in (-1, 1)]
                 + [[s2 * g, 0, s1] for s1 in (-1, 1) for s2 in (-1, 1)],
                 float)
    return np.asarray(centre) + radius * v / np.linalg.norm(v[0])


def _scene(name):
    """(positions, velocities, masses, radii, max_merges) of the loop's
    scenes, each but "all_rows" with seeded far bodies of radius 1e-3
    around it:
    "chain" (only the first pair overlaps; each merge's body, heavier
    down the chain, overlaps the next), "host" (a heavy body of radius 0.5
    swallows six bodies inside it one by one, nearest first: its dead
    tracers collect on it), "hub" (a pair merges at the centre of a ring of twelve dead
    rows, whose nearest live bodies were twelve anchors: all take the
    merged body through the update), "all_rows" (a pair at the centre of
    an icosahedron of twelve bodies, no far bodies: every row's neighbour
    is one of the pair, so the full search takes the rows) and "crowd" (40 bodies of radius 0.2 in a unit box:
    max_merges is reached)."""
    rng = np.random.default_rng(3)
    if name == "chain":
        # spacings that grow along the chain, so that the merged body and
        # the next one are the closest pair each time
        xs, ms = [0.0], [1.0]
        for k, gap in enumerate((0.02, 0.1005, 0.115, 0.12, 0.125, 0.13)):
            xs.append(xs[-1] + gap)
            ms.append(1.0 if k == 0 else 10.0 ** (2 * k + 2))
        pos = np.zeros((7, 3))
        pos[:, 0] = xs
        mass, radii, cap = np.array(ms), np.full(7, 0.05), 8
    elif name == "host":
        # on the six half axes, each nearer the host than to any other
        pos = np.zeros((7, 3))
        for k, (axis, sign) in enumerate([(0, 1), (1, 1), (2, 1), (0, -1),
                                          (1, -1), (2, -1)]):
            pos[k + 1, axis] = sign * (0.1 + 0.05 * k)
        mass = np.r_[100.0, rng.uniform(0.1, 1, 6)]
        radii, cap = np.r_[0.5, np.full(6, 0.01)], 8
    elif name == "hub":
        # twelve dead rows on a circle of radius 3 about the pair's
        # midpoint, each with a live anchor 3.1 further out as its nearest
        # (the pair is 3.16 away); the merged body at the midpoint is 3
        # away, so every dead row takes it, through the update
        ang = 2 * np.pi * np.arange(12) / 12
        ring = np.stack([np.zeros(12), np.cos(ang), np.sin(ang)], 1)
        pos = np.vstack([[[-1.0, 0, 0], [1.0, 0, 0]], 3 * ring, 6.1 * ring])
        mass = np.r_[1.0, 1.0, np.zeros(12), np.ones(12)]
        radii = np.r_[1.1, 1.1, np.zeros(12), np.full(12, 0.01)]
        cap = 8
    elif name == "all_rows":
        pos = np.vstack([[[-0.01, 0, 0], [0.01, 0, 0]],
                         _icosahedron([0, 0, 0], 1.0)])
        mass, radii, cap = np.ones(14), np.r_[0.02, 0.02, np.full(12,
                                                                  0.01)], 8
        return pos, rng.normal(size=pos.shape), mass, radii, cap
    else:
        pos = rng.uniform(0, 1, (40, 3))
        mass, radii, cap = rng.uniform(0.1, 1, 40), np.full(40, 0.2), 3
    far = rng.uniform(5, 50, (20, 3)) * rng.choice([-1, 1], (20, 3))
    pos = np.vstack([pos, far])
    vel = rng.normal(size=pos.shape)
    return (pos, vel, np.r_[mass, rng.uniform(0.1, 1, 20)],
            np.r_[radii, np.full(20, 1e-3)], cap)


def _overlapping_pairs(pos, radii):
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    live = radii > 0
    hit = (d < radii[:, None] + radii[None]) & live[:, None] & live[None]
    return int(np.triu(hit, 1).sum())


@pytest.mark.parametrize("name", ["chain", "host", "hub", "all_rows",
                                  "crowd"])
def test_incremental_loop_matches_a_loop_of_merge_closest(name,
                                                          monkeypatch):
    """merge_all_overlapping keeps the nearest-neighbour table across its
    merges; after each merge (max_merges = 1, 2, ...) its state, radii,
    count and energy lost are a loop of the port's merge_closest bit for
    bit and the JAX package's merge_all_overlapping to 1e-12; each call
    makes one full search, and a second only where the update leaves more
    than half the rows (all_rows)."""
    pos, vel, mass, radii, cap = _scene(name)
    if name == "chain":
        assert _overlapping_pairs(pos, radii) == 1
    ts, js = _both(pos, vel, mass)
    tr = torch.as_tensor(radii)
    searches = []
    full = encounters.nearest_table

    def counted(*a, **kw):
        searches.append(1)
        return full(*a, **kw)

    monkeypatch.setattr(encounters, "nearest_table", counted)
    want = {"chain": 6, "host": 6, "hub": 1, "all_rows": 1, "crowd": 3}
    for k in range(1, want[name] + 2):
        searches.clear()
        st, r, n, de = collisions.merge_all_overlapping(ts, tr,
                                                        max_merges=k)
        assert len(searches) == (1 if name != "all_rows" or k < 2 else 2)
        lst, lr, ln, lde = merge_loop_full(ts, tr, k)
        assert (n, de) == (ln, lde)
        for f in ("pos", "vel", "mass", "acc"):
            assert torch.equal(getattr(st, f), getattr(lst, f)), f
        assert torch.equal(r, lr)
        jst, jr, jn, jde = jcol.merge_all_overlapping(
            js, jnp.asarray(radii), max_merges=k)
        assert n == jn and de == pytest.approx(jde, rel=1e-12, abs=0)
        _assert_state(st, jst)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-12)
        if k == cap:
            break
    assert n == min(want[name], cap)
    if name == "host":
        assert int((r[:7] == 0).sum()) == 6 and float(r[0]) > 0.5
    if name == "hub":
        best, idx = encounters.nearest_table(st.pos, r > 0)
        assert bool((idx[2:14] == 0).all())


def test_one_full_search_for_eight_merges(monkeypatch):
    """A crowd with more than eight overlapping pairs: eight merges, one
    full search, and every other row found by the update or searched
    again (`nearest_rows`)."""
    rng = np.random.default_rng(11)
    pos = rng.uniform(0, 1, (60, 3))
    ts, _ = _both(pos, rng.normal(size=(60, 3)), rng.uniform(0.1, 1, 60))
    radii = torch.full((60,), 0.15, dtype=torch.float64)
    assert _overlapping_pairs(pos, radii.numpy()) > 8
    calls = {"full": 0, "rows": 0}
    full, rows = encounters.nearest_table, encounters.nearest_rows

    def counted_full(*a, **kw):
        calls["full"] += 1
        return full(*a, **kw)

    def counted_rows(*a, **kw):
        calls["rows"] += 1
        return rows(*a, **kw)

    monkeypatch.setattr(encounters, "nearest_table", counted_full)
    monkeypatch.setattr(encounters, "nearest_rows", counted_rows)
    st, r, n, _ = collisions.merge_all_overlapping(ts, radii, max_merges=8)
    assert n == 8 and calls == {"full": 1, "rows": 7}
    lst, lr, ln, _ = merge_loop_full(ts, radii, 8)
    assert ln == 8 and torch.equal(st.pos, lst.pos) and torch.equal(r, lr)
