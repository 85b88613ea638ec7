"""The port's own native oracle (`spacetpu_torch.native`: ctypes over
`native/nbody_ref.cpp`, built into `spacetpu_torch/_build/`) against
`spacetpu.native` on the same inputs, and the port's strip tree against
its octree (tests/test_parity.py:52 on the port).

Both libraries are compiled from the same source with the same flags on
the same machine, so their four calls agree bit for bit. The tree rollout
is held at the theta-truncation scale of tests/test_parity.py:52, not at
rounding."""

import numpy as np
import pytest
import torch

import spacetpu_torch
from spacetpu import native as jnative
from spacetpu.constants import COLLISION_EPSILON, DELTA, G
from spacetpu.models import presets as jpresets
from spacetpu_torch import native
from spacetpu_torch.models import presets
from tests.parity import one_torch_thread  # noqa: F401

LAWS = {"ref": COLLISION_EPSILON, "plummer": 1e-4}


@pytest.fixture(scope="module")
def scene():
    return jpresets.fixed_cloud(300)


def _calls(lib, sc, softening):
    eps = LAWS[softening]
    kw = dict(g=G, eps=eps, softening=softening)
    return {
        "acc_direct": lambda: lib.acc_direct(sc.pos, sc.mass, **kw),
        "acc_barnes_hut": lambda: lib.acc_barnes_hut(sc.pos, sc.mass,
                                                     theta=0.4, **kw),
        "rollout": lambda: np.concatenate(lib.rollout(
            sc.pos, sc.vel, sc.mass, dt=DELTA, steps=5,
            algorithm="barnes_hut", theta=0.4, **kw)),
        "total_energy": lambda: np.float64(lib.total_energy(
            sc.pos, sc.vel, sc.mass, **kw)),
    }


@pytest.mark.parametrize("softening", sorted(LAWS))
@pytest.mark.parametrize("call", ["acc_direct", "acc_barnes_hut", "rollout",
                                  "total_energy"])
def test_calls_equal_spacetpu_native_bit_for_bit(scene, call, softening):
    got = _calls(native, scene, softening)[call]()
    want = _calls(jnative, scene, softening)[call]()
    assert got.dtype == np.float64 and got.shape == np.shape(want)
    np.testing.assert_array_equal(got, want)


def test_tensors_on_any_device_are_taken(scene):
    got = native.acc_direct(torch.as_tensor(scene.pos, dtype=torch.float32),
                            torch.as_tensor(scene.mass), g=G, eps=1e-4,
                            softening="plummer")
    want = native.acc_direct(np.asarray(scene.pos, np.float32), scene.mass,
                             g=G, eps=1e-4, softening="plummer")
    np.testing.assert_array_equal(got, want)


def test_build_goes_to_the_package_not_native():
    path = native.build()
    assert path == native.library_path() and path.exists()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parent.name == "spacetpu_torch"
    assert not list(native.BUILD_DIR.glob("nbody_ref-*.tmp"))


def test_fixed_cloud_strip_tree_vs_native_tree_rollout():
    """tests/test_parity.py:52 on the port: its strip tree (the kernel
    backend, on CPU tensors its plain versions) and the native octree,
    euler/plummer at theta 0.4 for 25 steps, agree to 5% of the median
    displacement."""
    sc = presets.fixed_cloud(600)
    sim = spacetpu_torch.make_simulation(
        sc.n, algorithm="tree", backend="cuda", near_mode="strip",
        integrator="euler", softening="plummer", eps=1e-4, theta=0.4, g=G,
        device="cpu")
    state = sim.run(sc.state(dtype=torch.float64, device="cpu"), DELTA, 25)
    p_tree, _ = native.rollout(sc.pos, sc.vel, sc.mass, dt=DELTA, steps=25,
                               g=G, eps=1e-4, softening="plummer",
                               algorithm="barnes_hut", theta=0.4)
    moved = np.linalg.norm(p_tree - np.asarray(sc.pos), axis=-1)
    err = np.linalg.norm(state.pos.numpy() - p_tree, axis=-1)
    scale = np.median(moved) + 1e-30
    assert np.median(err) / scale < 0.05, (np.median(err), scale)
