"""Helpers of the PyTorch port's parity tests (`tests/test_torch_*.py`).

- The JAX package's functions through `jax.jit`. On the CPU nearly all of
  the JAX package's time in those tests is compiling: run eagerly, every
  primitive compiles on its own for every new shape; through `jax.jit` a
  function compiles once. The results are the same functions' results;
  nothing in the package changes.
- One PyTorch thread a test process: the suite runs in several processes
  at once, and PyTorch's default of a thread a core in each of them
  oversubscribes the cores several times over.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from spacetpu.ops import tree as jtree

#: host-side helpers of `spacetpu.ops.tree` that `measure_near`,
#: `tree_prep` and `Simulation.calibrate` call eagerly, with the positions
#: and names of their static arguments
_TREE_HELPERS = {
    "_build_clustering": ((2, 3, 4), ("gg", "leaf", "cluster_mode")),
    "_super_stats": ((), ("group",)),
    "_super_accept": ((4,), ("theta",)),
    "_super_screen": ((4, 5), ("theta", "k_super", "n2")),
    "_mid_near_lists": ((9, 10), ("theta", "k_mid")),
    "_m1_lists": ((2,), ("gg",)),
}


def call(fn, *arrays, **static):
    """fn(*arrays, **static) through jax.jit, numpy inputs as JAX arrays."""
    return jax.jit(functools.partial(fn, **static))(
        *(jax.tree_util.tree_map(jnp.asarray, a) for a in arrays))


def jit_tree_helpers(monkeypatch):
    """Replace the eager helpers of `spacetpu.ops.tree` by their jitted
    selves for the life of `monkeypatch`."""
    for name, (nums, names) in _TREE_HELPERS.items():
        monkeypatch.setattr(jtree, name, jax.jit(
            getattr(jtree, name), static_argnums=nums,
            static_argnames=names))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Autouse in every module that imports it: PyTorch on one thread for
    the module's tests, restored afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
