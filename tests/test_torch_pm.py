"""The particle-mesh solver of the port (`spacetpu_torch/ops/pm.py`) and the
PM half of its `Simulation` against `spacetpu`'s, on the CPU in float64:
the box, the grid and the transform names, the kernel spectrum, the CIC
deposit (compact and full), the acceleration (compact and full-mesh
oracle), the out-of-box count, the mesh potential energy, and
`make_simulation(algorithm="pm")` through prime, steps, caps, mesh_params,
health and recalibration. JAX runs jitted (`tests/parity.py`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spacetpu
import spacetpu_torch
from spacetpu.ops import pm as jpm
from spacetpu.state import make_state as jmake_state
from spacetpu_torch.ops import pm as tpm
from spacetpu_torch.state import make_state as tmake_state
from tests import parity
from tests.parity import one_torch_thread  # noqa: F401


def _cloud(n, seed=0, trunc=0.9):
    """The truncated Plummer cloud of tests/test_pm.py."""
    rng = np.random.default_rng(seed)
    m_enc = rng.uniform(0.0, trunc, n)
    r = 1.0 / np.sqrt(m_enc ** (-2.0 / 3.0) - 1.0)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    return r[:, None] * u, rng.uniform(0.5, 1.5, n)


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def mesh():
    pos, mass = _cloud(513, seed=7)
    box_min, h = jpm.measure_box(pos, grid=16, margin=2.0)
    return dict(pos=pos, mass=mass, box_min=box_min, h=h, grid=16,
                jk=jpm.pm_kernel_hat(16, h, eps=0.0, g=1.0,
                                     dtype=jnp.float64),
                tk=tpm.pm_kernel_hat(16, h, eps=0.0, g=1.0,
                                     dtype=torch.float64, device="cpu"))


def test_box_grid_and_transform_names(mesh):
    """measure_box, default_grid and fft_method as the JAX package answers
    them off a TPU ("auto" is "fft"; "matmul" is accepted)."""
    for margin in (1.0, 2.0):
        want = jpm.measure_box(mesh["pos"], grid=16, margin=margin)
        got = tpm.measure_box(_t(mesh["pos"]), grid=16, margin=margin)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    for n in (1, 8, 1000, 30_000, 262_144, 1_000_001, 10 ** 8):
        assert tpm.default_grid(n) == jpm.default_grid(n)
    for method in (None, "auto", "fft", "matmul"):
        assert tpm.fft_method(method) == jpm.fft_method(method)
    with pytest.raises(ValueError, match="FFT method"):
        tpm.fft_method("dft")


@pytest.mark.parametrize("grid,eps", [(8, 0.0), (16, 0.0), (16, 0.3)])
def test_kernel_hat_matches_jax(grid, eps):
    """The spectrum built from the min-image corner on the device against
    the host numpy build: 1e-12 of its largest entry."""
    want = jpm.pm_kernel_hat(grid, 0.37, eps=eps, g=1.3, dtype=jnp.float64)
    got = tpm.pm_kernel_hat(grid, 0.37, eps=eps, g=1.3,
                            dtype=torch.float64, device="cpu")
    assert got.shape == want.shape == (2 * grid, 2 * grid, grid + 1)
    _close(got, want, 1e-12)
    assert tpm.pm_self_kernel(0.37, eps=eps, g=1.3) == jpm.pm_self_kernel(
        0.37, eps=eps, g=1.3)


@pytest.mark.parametrize("form", ["compact", "full"])
def test_deposit_matches_jax(mesh, form):
    """CIC deposit by one index_add_ against the JAX scatter: 1e-12 of the
    heaviest cell; the compact mesh is the occupied corner of the full."""
    fn = {"compact": "deposit_cic_compact", "full": "deposit_cic"}[form]
    inv_h = 1.0 / mesh["h"]
    want = parity.call(getattr(jpm, fn), mesh["pos"], mesh["mass"],
                       box_min=mesh["box_min"], inv_h=inv_h, grid=16)
    got = getattr(tpm, fn)(_t(mesh["pos"]), _t(mesh["mass"]),
                           box_min=_t(mesh["box_min"]), inv_h=inv_h, grid=16)
    _close(got, want, 1e-12)
    if form == "full":
        assert float(got[17:].abs().max()) == 0.0
        np.testing.assert_allclose(float(got.sum()), mesh["mass"].sum(),
                                   rtol=1e-12)


def test_acc_pm_matches_jax(mesh):
    """acc_pm (compact deposit, windowed solve, gather) against JAX to 1e-10
    of max|a|; the full doubled-mesh oracle and the compact window against
    the port's own compact path, as tests/test_pm.py:87-153 holds them; the
    potential window against JAX's."""
    kw = dict(box_min=mesh["box_min"], h=mesh["h"], grid=16)
    want = parity.call(jpm.acc_pm, mesh["pos"], mesh["mass"],
                       kernel_hat=mesh["jk"], **kw)
    pos, mass = _t(mesh["pos"]), _t(mesh["mass"])
    got = tpm.acc_pm(pos, mass, kernel_hat=mesh["tk"], **kw)
    _close(got, want, 1e-10)
    box, inv_h = _t(mesh["box_min"]), 1.0 / mesh["h"]
    full = tpm.deposit_cic(pos, mass, box_min=box, inv_h=inv_h, grid=16)
    oracle = tpm.acc_from_mesh(pos, full, kernel_hat=mesh["tk"],
                               box_min=box, inv_h=inv_h, grid=16)
    _close(got, oracle.numpy(), 1e-12)
    comp = tpm.deposit_cic_compact(pos, mass, box_min=box, inv_h=inv_h,
                                   grid=16)
    _close(tpm.potential_ext(comp, mesh["tk"], 16, method="matmul"),
           parity.call(jpm.potential_ext, comp.numpy(), mesh["jk"],
                       grid=16, method="fft"), 1e-10)
    # a single body feels no force of its own
    one = tpm.acc_pm(pos[:1], mass[:1], kernel_hat=mesh["tk"], **kw)
    assert float(one.abs().max()) < 1e-12


def test_out_of_box_count_and_energy(mesh):
    """count_out_of_box after a quarter of the bodies leave the box, and
    potential_energy_pm (1e-10 relative), against JAX."""
    moved = mesh["pos"].copy()
    moved[::4] *= 3.0
    args = (mesh["box_min"], mesh["h"], 16)
    for p in (mesh["pos"], moved):
        assert int(tpm.count_out_of_box(_t(p), *args)) == int(
            jpm.count_out_of_box(jnp.asarray(p), *args))
    k0 = tpm.pm_self_kernel(mesh["h"], g=1.0)
    kw = dict(box_min=mesh["box_min"], h=mesh["h"], grid=16, k0=k0)
    want = float(parity.call(jpm.potential_energy_pm, mesh["pos"],
                             mesh["mass"], kernel_hat=mesh["jk"], **kw))
    got = float(tpm.potential_energy_pm(_t(mesh["pos"]), _t(mesh["mass"]),
                                        kernel_hat=mesh["tk"], **kw))
    assert got == pytest.approx(want, rel=1e-10)


def _states(pos, mass):
    vel = np.zeros_like(pos)
    return (tmake_state(pos, vel, mass, dtype=torch.float64, device="cpu"),
            jmake_state(pos, vel, mass, dtype=jnp.float64))


def test_pm_simulation_matches_jax():
    """make_simulation(algorithm="pm"): a step before prime raises; prime
    calibrates the same box, grid and kernel; four leapfrog steps agree to
    1e-9; caps stay empty; health and jit_consts answer as JAX's."""
    pos, mass = _cloud(256, seed=3)
    kw = dict(algorithm="pm", g=1.0, pm_grid=16)
    sim = spacetpu_torch.make_simulation(256, device="cpu", **kw)
    jsim = spacetpu.make_simulation(256, backend="xla", **kw)
    ts, js = _states(pos, mass)
    assert sim.mesh_params is None and sim.health(ts) == {}
    with pytest.raises(RuntimeError, match="uncalibrated"):
        sim.step(ts, 1e-3)
    ts = sim.prime(ts)
    js = jsim.prime(js)
    mp, jmp = sim.mesh_params, jsim.mesh_params
    assert mp["grid"] == jmp["grid"] == 16 and mp["h"] == jmp["h"]
    np.testing.assert_array_equal(mp["box_min"], jmp["box_min"])
    _close(mp["kernel_hat"], jmp["kernel_hat"], 1e-12)
    assert set(sim.jit_consts) == set(jsim.jit_consts)
    for _ in range(4):
        ts = sim.step(ts, 1e-3)
        js = jsim.step(js, 1e-3)
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), rtol=1e-9,
                               atol=1e-12)
    _close(ts.acc, js.acc, 1e-9)
    assert sim.caps == jsim.caps
    assert sim.health(ts) == jsim.health(js) == {
        "algorithm": "pm", "out_of_box": 0, "grid": 16}
    assert sim.degenerate is None


def test_pm_recalibrates_after_an_escape():
    """tests/test_pm.py:214 on the port: healthy, no rebuild; a tenth of
    the bodies teleported out of the box triggers one, with a larger cell,
    after which nothing is out of the box. The new box is JAX's."""
    pos, mass = _cloud(256, seed=5)
    kw = dict(algorithm="pm", g=1.0, pm_grid=16, pm_margin=1.2)
    sim = spacetpu_torch.make_simulation(256, device="cpu", **kw)
    ts = sim.prime(_states(pos, mass)[0])
    assert not sim.maybe_recalibrate(ts)
    moved = pos.copy()
    moved[:26] *= 50.0
    ts2 = ts._replace(pos=_t(moved))
    old_h, epoch = sim.mesh_params["h"], sim.jit_epoch
    assert sim.health(ts2)["out_of_box"] > 0
    assert sim.maybe_recalibrate(ts2)
    assert sim.mesh_params["h"] > old_h and sim.jit_epoch == epoch + 1
    assert sim.health(ts2)["out_of_box"] == 0
    want = jpm.measure_box(moved, grid=16, margin=1.2)
    np.testing.assert_array_equal(sim.mesh_params["box_min"], want[0])
    assert sim.mesh_params["h"] == want[1]
    assert np.isfinite(sim.step(ts2, 1e-3).pos.numpy()).all()


def test_pm_refuses_multirate():
    with pytest.raises(ValueError, match="pm"):
        spacetpu_torch.make_simulation(128, algorithm="pm", substeps=4,
                                       device="cpu")
