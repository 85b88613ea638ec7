"""The port's all-pairs solver against `spacetpu`'s, on the CPU.

The plain PyTorch forms (`ops/direct.py`) and the kernel wrappers of
`ops/cuda_direct.py`, which take the plain versions for CPU tensors, are
held against `spacetpu.ops.direct` and against the Pallas kernels run in
interpret mode. Tolerances: float32 as tests/test_pallas.py:26
(rtol 2e-5, atol 1e-6); float64 1e-10 of max|a|, where only the order of
the sums differs. The kernels themselves run on the card only
(tests/test_torch_gpu.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetpu.ops import direct as jdirect
from spacetpu.ops import pallas_direct
from spacetpu_torch.ops import cuda_direct
from spacetpu_torch.ops import direct as tdirect
from tests import parity
from tests.parity import one_torch_thread  # noqa: F401

CASES = [("plummer", 1e-2), ("plummer", 0.0), ("ref", 1e-9), ("ref", 0.0),
         ("ref", None)]


def _bodies(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, size=(n, 3)), rng.uniform(0.1, 1.0, size=n)


def _t(x, dtype):
    return torch.as_tensor(x, dtype=getattr(torch, dtype))


def _j(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype))


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.isfinite(got))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    else:
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def test_subnormal_float32_eps_squared_matches_xla():
    """Float32 plummer at eps 1e-20, whose square is a subnormal float32:
    `spacetpu`'s XLA path flushes eps^2 to 0, so its d2 > 0 mask drops the
    self pair; the port takes eps^2 as 0 there too (`plummer_eps2`), where
    keeping the subnormal made every force NaN (inf times a zero
    difference). Both forms, all pairs and chunked, are finite and agree."""
    pos, mass = _bodies(64, seed=64)
    want = jdirect.acc_direct(_j(pos, "float32"), _j(mass, "float32"),
                              softening="plummer", eps=1e-20, g=1.0)
    assert np.all(np.isfinite(np.asarray(want)))
    t_pos, t_mass = _t(pos, "float32"), _t(mass, "float32")
    kw = dict(softening="plummer", eps=1e-20, g=1.0)
    _close(tdirect.acc_direct(t_pos, t_mass, **kw), want, "float32")
    _close(tdirect.acc_cross_chunked(t_pos, t_pos, t_mass, chunk=16, **kw),
           want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("softening,eps", CASES)
def test_acc_direct_matches_jax(softening, eps, dtype):
    pos, mass = _bodies(100, seed=1)
    want = jdirect.acc_direct(_j(pos, dtype), _j(mass, dtype),
                              softening=softening, eps=eps, g=1.0)
    got = tdirect.acc_direct(_t(pos, dtype), _t(mass, dtype),
                             softening=softening, eps=eps, g=1.0)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("softening,eps", CASES)
def test_acc_cross_and_chunked_match_jax(softening, eps):
    pi, _ = _bodies(64, seed=2)
    pj, mj = _bodies(192, seed=3)
    want = jdirect.acc_cross(_j(pi, "float64"), _j(pj, "float64"),
                             _j(mj, "float64"), softening=softening, eps=eps,
                             g=1.0)
    args = (_t(pi, "float64"), _t(pj, "float64"), _t(mj, "float64"))
    kw = dict(softening=softening, eps=eps, g=1.0)
    _close(tdirect.acc_cross(*args, **kw), want, "float64")
    # ragged chunks on both axes
    _close(tdirect.acc_cross_chunked(*args, chunk=50, **kw), want, "float64")
    want_c = jdirect.acc_cross_chunked(
        _j(pi, "float64"), _j(pj, "float64"), _j(mj, "float64"), chunk=50,
        **kw)
    _close(tdirect.acc_cross_chunked(*args, chunk=50, **kw), want_c,
           "float64")


@pytest.mark.parametrize("softening,eps", [("plummer", 1e-2), ("ref", 0.0)])
def test_acc_direct_chunked_matches_jax(softening, eps):
    pos, mass = _bodies(128, seed=4)
    kw = dict(softening=softening, eps=eps, g=1.0, chunk=32)
    want = jdirect.acc_direct_chunked(_j(pos, "float64"), _j(mass, "float64"),
                                      **kw)
    got = tdirect.acc_direct_chunked(_t(pos, "float64"), _t(mass, "float64"),
                                     **kw)
    _close(got, want, "float64")
    with pytest.raises(ValueError, match="divisible"):
        tdirect.acc_direct_chunked(_t(pos[:100], "float64"),
                                   _t(mass[:100], "float64"), **kw)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("softening,eps", [("plummer", 1e-2),
                                           ("plummer", 0.0), ("ref", 1e-9),
                                           ("ref", 0.0)])
@pytest.mark.parametrize("m,k", [(100, 100), (64, 192)])
def test_kernel_wrapper_matches_pallas(softening, eps, dtype, m, k):
    """CPU tensors take the plain version of direct_vpu; it matches the
    Pallas kernel in interpret mode (ragged N=100, cross 64x192)."""
    pj, mj = _bodies(k, seed=5)
    pi = pj if m == k else _bodies(m, seed=6)[0]
    kw = dict(softening=softening, eps=eps, g=1.0)
    want = pallas_direct.acc_cross_pallas(
        _j(pi, dtype), _j(pj, dtype), _j(mj, dtype), tile_i=64, tile_j=128,
        interpret=True, **kw)
    before = dict(cuda_direct.LAUNCHES)
    got = cuda_direct.acc_cross_kernel(_t(pi, dtype), _t(pj, dtype),
                                       _t(mj, dtype), **kw)
    assert cuda_direct.LAUNCHES == before  # the plain path launches nothing
    assert got.shape == (m, 3)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("m,k", [(256, 256), (64, 192)])
def test_mxu_plain_matches_jax(dtype, m, k):
    """The plain expanded form against the JAX mxu kernel in interpret mode.
    That kernel forms its dot products in float32 whatever the input dtype,
    so it is held to the band of tests/test_pallas.py:66-79; in float64 the
    port's expanded form is also held to the exact law at 1e-10 of max|a|."""
    pj, mj = _bodies(k, seed=7)
    pi = pj if m == k else _bodies(m, seed=8)[0]
    kw = dict(eps=1e-2, g=1.0)
    jargs = (_j(pi, dtype), _j(pj, dtype), _j(mj, dtype))
    want = np.asarray(parity.call(
        pallas_direct.acc_cross_pallas, *jargs, softening="plummer",
        tile_i=64, tile_j=128, interpret=True, method="mxu", **kw),
        np.float64)
    args = (_t(pi, dtype), _t(pj, dtype), _t(mj, dtype))
    plain = cuda_direct.acc_cross_mxu_plain(*args, **kw)
    wrapped = cuda_direct.acc_cross_kernel(*args, softening="plummer",
                                           method="mxu", **kw)
    torch.testing.assert_close(wrapped, plain, rtol=0, atol=0)
    got = plain.double().numpy()
    scale = np.linalg.norm(want, axis=1).max()
    assert np.linalg.norm(got - want, axis=1).max() / scale < 2e-3
    if dtype == "float64":
        exact = jdirect.acc_cross(*jargs, softening="plummer", **kw)
        _close(got, exact, dtype)


def test_mxu_within_band_of_exact():
    """tests/test_pallas.py:66-79: mxu within 2e-3 of the exact form."""
    pos, mass = _bodies(256, seed=7)
    args = (_t(pos, "float32"), _t(pos, "float32"), _t(mass, "float32"))
    kw = dict(softening="plummer", eps=1e-2, g=1.0)
    a_vpu = cuda_direct.acc_cross_kernel(*args, **kw).numpy()
    a_mxu = cuda_direct.acc_cross_kernel(*args, method="mxu", **kw).numpy()
    scale = np.linalg.norm(a_vpu, axis=1).max()
    assert np.linalg.norm(a_mxu - a_vpu, axis=1).max() / scale < 2e-3


def test_mxu_preconditions():
    pos, mass = _t(_bodies(16, 9)[0], "float32"), torch.ones(16)
    with pytest.raises(ValueError, match="plummer"):
        cuda_direct.acc_cross_kernel(pos, pos, mass, softening="ref",
                                     eps=1e-2, method="mxu")
    with pytest.raises(ValueError, match="eps > 0"):
        cuda_direct.acc_cross_kernel(pos, pos, mass, softening="plummer",
                                     eps=0.0, method="mxu")
    with pytest.raises(ValueError, match="eps > 0"):
        cuda_direct.acc_cross_mxu_plain(pos, pos, mass, eps=0.0)
    with pytest.raises(ValueError, match="method"):
        cuda_direct.acc_cross_kernel(pos, pos, mass, method="tensor")


def test_kernel_wrapper_rejects_bad_inputs():
    pos = torch.zeros(8, 3)
    with pytest.raises(TypeError, match="dtype"):
        cuda_direct.acc_cross_kernel(pos.half(), pos.half(),
                                     torch.ones(8).half())
    with pytest.raises(TypeError, match="one dtype"):
        cuda_direct.acc_cross_kernel(pos, pos.double(), torch.ones(8))
    with pytest.raises(ValueError, match="bad shapes"):
        cuda_direct.acc_cross_kernel(pos, pos, torch.ones(7))
