"""The port's integrators and energy diagnostics against `spacetpu`'s, in
float64 on the CPU: the same states and force law through both packages
(rtol 1e-12: only the order of the force sums differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetpu.models import presets as jpresets
from spacetpu.ops import direct as jdirect
from spacetpu.ops import energy as jenergy
from spacetpu.ops import integrators as jint
from spacetpu_torch.models import presets as tpresets
from spacetpu_torch.ops import direct as tdirect
from spacetpu_torch.ops import energy as tenergy
from spacetpu_torch.ops import integrators as tint
from tests.parity import one_torch_thread  # noqa: F401

KW = dict(softening="plummer", eps=1e-2, g=1.0)


def _states(compensated, n=48):
    t = tpresets.random_cluster(n, seed=3).state(
        dtype=torch.float64, compensated=compensated, device="cpu")
    j = jpresets.random_cluster(n, seed=3).state(dtype=jnp.float64,
                                                 compensated=compensated)
    return t, j


def _assert_states_close(t, j):
    for field in ("pos", "vel", "acc", "pos_c", "vel_c", "time"):
        a, b = getattr(t, field), getattr(j, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                       atol=1e-15, err_msg=field)


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("name", ["euler", "leapfrog", "yoshida4"])
def test_steppers_match_jax(name, compensated):
    t, j = _states(compensated)
    t = tint.prime(t, lambda p, m: tdirect.acc_direct(p, m, **KW))
    j = jint.prime(j, lambda p, m: jdirect.acc_direct(p, m, **KW))
    t_step, j_step = tint.get_stepper(name), jint.get_stepper(name)
    for _ in range(5):
        t = t_step(t, 1e-2, lambda p, m: tdirect.acc_direct(p, m, **KW))
        j = j_step(j, 1e-2, lambda p, m: jdirect.acc_direct(p, m, **KW))
    _assert_states_close(t, j)


def test_yoshida4_time_advances_by_dt():
    t, _ = _states(False, n=8)
    t = tint.prime(t, lambda p, m: tdirect.acc_direct(p, m, **KW))
    t = tint.step_yoshida4(t, 0.1, lambda p, m: tdirect.acc_direct(p, m, **KW))
    assert float(t.time) == 0.1


def test_float32_dt_rounding_matches_jax():
    """dt is cast to the state's dtype first, as in JAX: float32 leapfrog
    steps through both packages agree to float32 rounding."""
    t = tpresets.random_cluster(32, seed=4).state(device="cpu")
    j = jpresets.random_cluster(32, seed=4).state()
    t = tint.prime(t, lambda p, m: tdirect.acc_direct(p, m, **KW))
    j = jint.prime(j, lambda p, m: jdirect.acc_direct(p, m, **KW))
    for _ in range(3):
        t = tint.step_leapfrog(t, 1e-3,
                               lambda p, m: tdirect.acc_direct(p, m, **KW))
        j = jint.step_leapfrog(j, 1e-3,
                               lambda p, m: jdirect.acc_direct(p, m, **KW))
    assert t.pos.dtype == torch.float32
    assert float(t.time) == float(j.time)
    np.testing.assert_allclose(t.pos.numpy(), np.asarray(j.pos), rtol=1e-6,
                               atol=1e-7)


def test_comp_add_matches_jax():
    rng = np.random.default_rng(5)
    x, c, dx = (rng.normal(size=64) * s for s in (1e3, 1e-13, 1e-6))
    tx, tc = tint._comp_add(torch.tensor(x), torch.tensor(c), torch.tensor(dx))
    jx, jc = jint._comp_add(jnp.asarray(x), jnp.asarray(c), jnp.asarray(dx))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tint._comp_add(torch.tensor(x), None, torch.tensor(dx))[1] is None


def test_get_stepper_rejects_unknown():
    with pytest.raises(ValueError, match="unknown integrator"):
        tint.get_stepper("rk4")


@pytest.mark.parametrize("softening,eps", [("plummer", 1e-2),
                                           ("plummer", 0.0), ("ref", 0.0)])
def test_energy_diagnostics_match_jax(softening, eps):
    # 1100 bodies: more than one chunk of the pair sum, with a ragged end
    scene = jpresets.plummer_sphere(1100, seed=6)
    pos, vel, mass = scene.pos, scene.vel, scene.mass
    t = tenergy.diagnostics(
        tpresets.plummer_sphere(1100, seed=6).state(dtype=torch.float64,
                                                    device="cpu"),
        softening=softening, eps=eps, g=1.0)
    kw = dict(softening=softening, eps=eps, g=1.0)
    want = {
        "kinetic": jenergy.kinetic_energy(vel, mass),
        "potential": jenergy.potential_energy(jnp.asarray(pos),
                                              jnp.asarray(mass), **kw),
        "momentum": jenergy.momentum(vel, mass),
        "angular_momentum": jenergy.angular_momentum(pos, vel, mass),
    }
    want["energy"] = want["kinetic"] + want["potential"]
    for key, value in want.items():
        np.testing.assert_allclose(t[key].numpy(), np.asarray(value),
                                   rtol=1e-12, atol=1e-15, err_msg=key)
    np.testing.assert_allclose(
        float(tenergy.total_energy(torch.tensor(pos), torch.tensor(vel),
                                   torch.tensor(mass), **kw)),
        float(want["energy"]), rtol=1e-12)
