"""The port's presets and state construction against `spacetpu`'s: every
preset gives bit-identical host arrays, and `make_state` the same state."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetpu import state as jstate
from spacetpu.models import kepler as jkepler
from spacetpu.models import presets as jpresets
from spacetpu_torch import state as tstate
from spacetpu_torch.models import kepler as tkepler
from spacetpu_torch.models import presets as tpresets
from tests.parity import one_torch_thread  # noqa: F401

PRESET_ARGS = {
    "earth_sun_basic": {},
    "earth_sun_mars": {},
    "earth_sun_mars_ast": dict(n_asteroids=40, seed=3),
    "earth_sun_mars_big_boy": {},
    "fixed_cloud": dict(n_objects=100),
    "fixed_shell": dict(n_objects=50),
    "random_cluster": dict(n=256, seed=1, g=1.0),
    "plummer_sphere": dict(n=300, seed=2),
    "colliding_plummers": dict(n=200, seed=3),
}


def _assert_same_scene(a, b):
    assert a.names == b.names
    assert a.g == b.g
    for field in ("colors", "radii", "pos", "vel", "mass"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)


def test_registry_matches():
    assert sorted(tpresets.PRESETS) == sorted(jpresets.PRESETS)
    assert sorted(PRESET_ARGS) == sorted(tpresets.PRESETS)


@pytest.mark.parametrize("name", sorted(PRESET_ARGS))
def test_preset_bit_identical(name):
    kw = PRESET_ARGS[name]
    _assert_same_scene(tpresets.PRESETS[name](**kw),
                       jpresets.PRESETS[name](**kw))


@pytest.mark.parametrize("seed", [0, 7])
def test_random_cluster_seeds(seed):
    _assert_same_scene(tpresets.random_cluster(128, seed=seed),
                       jpresets.random_cluster(128, seed=seed))


@pytest.mark.parametrize("quirks", [False, True])
def test_convert_params_bit_identical(quirks):
    t = tkepler.convert_params(tpresets.earth_sun_mars_params(),
                               reference_quirks=quirks)
    j = jkepler.convert_params(jpresets.earth_sun_mars_params(),
                               reference_quirks=quirks)
    _assert_same_scene(t, j)


def test_from_bodies_matches():
    bodies = [("a", (1.0, 2.0, 3.0), (0.1, 0.0, 0.0), 5.0),
              ("b", (-1.0, 0.5, 0.0), (0.0, -0.2, 0.3), 0.25)]
    t = tstate.Scene.from_bodies([tstate.Body(*b) for b in bodies])
    j = jstate.Scene.from_bodies([jstate.Body(*b) for b in bodies])
    _assert_same_scene(t, j)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("compensated,pad_to", [(False, None), (True, 64)])
def test_make_state_matches(dtype, compensated, pad_to):
    scene = tpresets.fixed_cloud(40)
    t = scene.state(dtype=getattr(torch, dtype), compensated=compensated,
                    pad_to=pad_to, device="cpu")
    j = jpresets.fixed_cloud(40).state(dtype=getattr(jnp, dtype),
                                       compensated=compensated,
                                       pad_to=pad_to)
    for field in jstate.State._fields:
        a, b = getattr(t, field), getattr(j, field)
        assert (a is None) == (b is None), field
        if a is not None:
            assert a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=field)
            assert str(a.dtype)[6:] == str(np.asarray(b).dtype), field


def test_make_state_copies_and_checks_shapes():
    pos = np.zeros((4, 3))
    s = tstate.make_state(pos, np.zeros((4, 3)), np.ones(4), device="cpu",
                          dtype=torch.float64)
    s.pos.add_(1.0)
    assert pos.sum() == 0.0
    with pytest.raises(ValueError, match="bad shapes"):
        tstate.make_state(pos, np.zeros((3, 3)), np.ones(4), device="cpu")
