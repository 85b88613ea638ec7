"""The port's space-filling-curve keys and cluster gather plans
(`spacetpu_torch.ops.morton`, `.cluster`) against `spacetpu`'s, on the same
numpy inputs. Integer results are held bit for bit in float64, where both
packages quantize with the same operations in the same order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetpu.ops import cluster as jcluster
from spacetpu.ops import morton as jmorton
from spacetpu_torch.ops import cluster as tcluster
from spacetpu_torch.ops import morton as tmorton
from tests.parity import one_torch_thread  # noqa: F401


def _positions(n, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)) * [1.0, 0.5, 2.0] + [3.0, -1.0, 0.5]
            ).astype(dtype)


def test_spread_bits_matches_jax():
    x = np.arange(1 << 10, dtype=np.int64)
    got = tmorton._spread_bits_10(torch.from_numpy(x)).numpy()
    want = np.asarray(jmorton._spread_bits_10(jnp.asarray(x, jnp.uint32)))
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("box", ["data", "given"])
def test_quantize_matches_jax(box):
    pos = _positions(1500, seed=0)
    lo = hi = jlo = jhi = None
    if box == "given":
        lo, hi = np.full(3, -8.0), np.full(3, 9.0)
        jlo, jhi = jnp.asarray(lo), jnp.asarray(hi)
        lo, hi = torch.from_numpy(lo), torch.from_numpy(hi)
    got = tmorton._quantize(torch.from_numpy(pos), lo, hi).numpy()
    want = np.asarray(jmorton._quantize(jnp.asarray(pos), jlo, jhi))
    if box == "data":
        assert got.min() == 0 and got.max() == 1023
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("curve", ["hilbert", "morton"])
def test_keys_match_jax_bit_for_bit(curve):
    pos = _positions(2048, seed=1)
    name = f"{curve}_keys"
    got = getattr(tmorton, name)(torch.from_numpy(pos)).numpy()
    want = np.asarray(getattr(jmorton, name)(jnp.asarray(pos)))
    assert got.dtype == np.int64 and got.max() < 1 << 30 and got.min() >= 0
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("curve", ["hilbert", "morton"])
def test_order_matches_jax_with_ties(curve):
    """Repeated positions share a key: the stable sort keeps their order,
    as `jnp.argsort` does."""
    pos = _positions(700, seed=2)
    pos = np.concatenate([pos, pos[:300], pos[100:200]])
    perm, inv = tmorton.morton_order(torch.from_numpy(pos), curve=curve)
    jperm, jinv = jmorton.morton_order(jnp.asarray(pos), curve=curve)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    np.testing.assert_array_equal(perm[inv].numpy(), np.arange(len(pos)))


def test_float32_keys_differ_from_jax_by_at_most_a_cell_boundary():
    """In float32 a body on a cell boundary may land one cell over, so the
    permutation is not held there, only that nearly all keys agree."""
    pos = _positions(2048, seed=3, dtype=np.float32)
    got = tmorton.hilbert_keys(torch.from_numpy(pos)).numpy()
    want = np.asarray(jmorton.hilbert_keys(jnp.asarray(pos))).astype(np.int64)
    assert np.mean(got == want) > 0.99


@pytest.mark.parametrize("n,leaf,g_cap", [(1000, 31, 33), (992, 31, 32),
                                          (100, 15, 10), (5, 255, 1)])
def test_equal_clusters_match_jax(n, leaf, g_cap):
    got = tcluster.equal_clusters(n, leaf, g_cap, device="cpu")
    want = jcluster.equal_clusters(n, leaf, g_cap)
    for name in tcluster.Clusters._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_gather_and_unsort_match_jax():
    n, leaf, g_cap = 1000, 31, 33
    pos = _positions(n, seed=4)
    mass = np.random.default_rng(5).uniform(0.1, 1.0, n)
    tc = tcluster.equal_clusters(n, leaf, g_cap, device="cpu")
    jc = jcluster.equal_clusters(n, leaf, g_cap)
    pos_g, mass_g = tcluster.gather_clusters(torch.from_numpy(pos),
                                             torch.from_numpy(mass), tc)
    jpos_g, jmass_g = jcluster.gather_clusters(jnp.asarray(pos),
                                               jnp.asarray(mass), jc)
    np.testing.assert_array_equal(pos_g.numpy(), np.asarray(jpos_g))
    np.testing.assert_array_equal(mass_g.numpy(), np.asarray(jmass_g))
    assert float(mass_g.reshape(-1)[n:].abs().max()) == 0.0
    slots = np.random.default_rng(6).normal(size=(g_cap * leaf, 3))
    inv = np.random.default_rng(7).permutation(n)
    got = tcluster.unsort_slots(torch.from_numpy(slots), tc,
                                torch.from_numpy(inv))
    want = jcluster.unsort_slots(jnp.asarray(slots), jc, jnp.asarray(inv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,leaf,multiple", [(1000, 31, 1), (1000, 31, 64),
                                             (10, 255, 8)])
def test_g_cap_for_matches_jax(n, leaf, multiple):
    assert tcluster.g_cap_for(n, leaf, multiple) == jcluster.g_cap_for(
        n, leaf, multiple)
